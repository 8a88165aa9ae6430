"""The fp8 amax over a split batch, measured on any checkout of the port.

Runs the tiny fp32 Llama with fp8 projections (HYBRID, the native fp8
product's plain version on the CPU) for 3 AdamW steps on
``tests/test_torch_expert_parallel.py``'s weights (seed 1) and batches:
once in one process on the global batch, then at ``dp_shard=2`` under
FSDP2 in two gloo processes, each on its half. It prints both runs'
(loss, grad norm) per step. Where each process scales its half by the
amax of the whole batch, as the JAX package's jitted step does, step 1
agrees; where each took its own half's amax, it does not.

    python tests/fp8_amax_over_the_batch.py [path of a checkout]

Only the public API of ``accelerate_tpu_torch`` is used, so an older
checkout runs it too.
"""

import os
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                       os.path.join(os.path.dirname(__file__), os.pardir))
HERE = os.path.dirname(os.path.abspath(__file__))


def _paths():
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests"), HERE]


def steps(pc_kwargs, rank):
    from accelerate_tpu_torch import (
        Accelerator,
        FullyShardedDataParallelPlugin,
        Model,
        ParallelismConfig,
        adamw,
    )
    from accelerate_tpu_torch.models import LlamaConfig, LlamaForCausalLM, cross_entropy_loss
    from accelerate_tpu_torch.parallel.sharding import local_batch
    from test_torch_expert_parallel import _batches, _weights

    weights = _weights(LlamaForCausalLM, LlamaConfig.tiny(dtype=torch.float32), seed=1)
    module = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32, fp8=True))
    module.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    pc = ParallelismConfig(**pc_kwargs) if pc_kwargs else None
    acc = Accelerator(cpu=True, parallelism_config=pc,
                      fsdp_plugin=FullyShardedDataParallelPlugin() if pc_kwargs else None)
    acc.prepare(Model(module), adamw(1e-3))
    step = acc.prepare_train_step(
        lambda m, b: cross_entropy_loss(m(b["x"].long()), b["y"].long()), max_grad_norm=1.0)
    out = []
    for b in _batches():
        mine = local_batch(b, acc.parallelism_config, rank) if pc_kwargs else b
        _, m = step(acc.train_state, {k: torch.from_numpy(v) for k, v in mine.items()})
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out


def _rank(rank, init_file):
    _paths()
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=2)
    got = steps(dict(dp_shard_size=2), rank)
    if rank == 0:
        print("dp_shard=2:", got, flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    _paths()
    torch.set_num_threads(1)
    print("one process:", steps(None, 0), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank, args=(os.path.join(tmp, "rendezvous"),), nprocs=2, join=True,
                           start_method="spawn")
