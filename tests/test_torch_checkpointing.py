"""The port's checkpoints (accelerate_tpu_torch.checkpointing) against the
JAX package's, on a tiny Llama (2 layers, hidden 64, fp32, CPU).

- a port save/load round trip restores every tensor, count and state;
- a port run resumed mid-epoch takes the uninterrupted run's steps;
- a checkpoint the JAX Accelerator saved resumes in the port: the next two
  losses and grad norms agree with the JAX run's within rtol 1e-4 (the
  tolerance of test_torch_train.py), and the step counts and rates match;
- the port's model.safetensors loads in the JAX package to the flax tree
  of ``llama_params_to_flax`` and the same logits (rtol 1e-5), for both
  ``scan_layers`` settings;
- a checkpoint the port saved resumes in the JAX package's ``load_state``
  (optax's state structure in ``optimizer.bin``): the next two losses and
  grad norms agree with the port run's within rtol 1e-4, for a constant
  rate and for a schedule; the JAX package's ``jax`` RNG entry survives
  JAX → port → JAX;
- ``DISTRIBUTED_STATE_DICT`` (torch.distributed.checkpoint without a
  process group): the round trip, ``save_state(block=False)`` with steps
  taken while it persists, a second asynchronous save queued behind the
  first, a background failure raised by ``wait_for_checkpoint``; the JAX
  package's orbax directory and a second model refused;
- automatic naming, pruning and numbering; both model file layouts; the
  restricted unpickler; registered objects, hooks and the scheduler; the
  safetensors files of each package read by the other side.
"""

import logging
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import accelerate_tpu.data_loader as jdl
from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu import Model as JaxModel
from accelerate_tpu.models import LlamaConfig as JaxLlamaConfig
from accelerate_tpu.models import LlamaForCausalLM as JaxLlama
from accelerate_tpu.models import cross_entropy_loss as jax_cross_entropy
from accelerate_tpu.utils import ProjectConfiguration as JaxProjectConfiguration
from accelerate_tpu.utils import other as jax_other
from accelerate_tpu_torch import (
    Accelerator,
    ColumnDataset,
    FullyShardedDataParallelPlugin,
    Model,
    ProjectConfiguration,
    adamw,
    linear_schedule,
    set_seed,
)
from accelerate_tpu_torch import checkpointing
from accelerate_tpu_torch.models import (
    LlamaConfig,
    LlamaForCausalLM,
    cross_entropy_loss,
    llama_params_from_flax,
    llama_params_to_flax,
)
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState
from accelerate_tpu_torch.utils.other import load_safetensors, save_safetensors


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the driver runs several test processes at once,
    and torch's spinning thread pools would contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


WIDTH = dict(num_hidden_layers=2, hidden_size=64)
ROWS, SEQ, BATCH = 48, 17, 8  # 6 batches per epoch; 8 rows for the 8-device CPU mesh
SCHEDULE = dict(init_value=1e-3, end_value=1e-4, transition_steps=10)


@pytest.fixture(autouse=True)
def reset_port_state():
    yield
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()


def _tokens():
    return np.random.default_rng(0).integers(0, 256, (ROWS, SEQ), dtype=np.int32)


class RandomSampler:  # the name makes prepare shuffle with the seedable sampler
    pass


class _Spec:
    def __init__(self, dataset):
        self.dataset, self.batch_size, self.sampler, self.drop_last = (
            dataset, BATCH, RandomSampler(), True)


LR = 1e-3


def _port_run(tmp_path, seed=0, scan_layers=True, scheduled=True, **acc_kw):
    """A port Accelerator with the tiny Llama (weights from `seed`), a
    scheduled adamw (a constant rate with ``scheduled=False``), a
    shuffling loader and its scheduler."""
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    acc = Accelerator(cpu=True, project_config=ProjectConfiguration(
        project_dir=str(tmp_path), automatic_checkpoint_naming=True), **acc_kw)
    cfg = LlamaConfig.tiny(dtype=torch.float32, scan_layers=scan_layers, **WIDTH)
    module = LlamaForCausalLM(cfg)
    module.init_weights(torch.Generator().manual_seed(seed))
    schedule = linear_schedule(**SCHEDULE) if scheduled else (lambda count: LR)
    model, opt, loader, sched = acc.prepare(
        Model(module), adamw(schedule if scheduled else LR),
        _Spec(ColumnDataset(ids=_tokens())), schedule)

    def loss_fn(m, b):
        ids = b["ids"].long()
        return cross_entropy_loss(m(ids[:, :-1]), ids[:, 1:])

    return acc, acc.prepare_train_step(loss_fn, max_grad_norm=1.0), loader, sched


def _steps(acc, step, loader, sched, n, it=None):
    """`n` steps from the loader across epochs; (metrics, live iterator)."""
    out = []
    while len(out) < n:
        it = it or iter(loader)
        batch = next(it, None)
        if batch is None:
            it = None
            continue
        _, m = step(acc.train_state, batch)
        sched.step()
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out, it


def _snapshot(acc):
    st = acc.train_state
    opt = st.optimizer
    return {
        "params": {n: p.detach().clone() for n, p in st.model.module.named_parameters()},
        "moments": {n: {k: v.clone() for k, v in opt.state[p].items()}
                    for n, p in st.model.module.named_parameters()},
        "step": st.step, "count": opt.count,
    }


def test_port_round_trip_restores_every_tensor(tmp_path):
    acc, step, loader, sched = _port_run(tmp_path)
    _, it = _steps(acc, step, loader, sched, 3)

    class Counter:
        def __init__(self, n):
            self.n = n

        def state_dict(self):
            return {"n": self.n}

        def load_state_dict(self, sd):
            self.n = sd["n"]

    acc.register_for_checkpointing(Counter(7))
    want, want_loader = _snapshot(acc), loader.state_dict()
    out = acc.save_state()
    assert sorted(os.listdir(out)) == sorted([
        "model.safetensors", "optimizer.bin", "scheduler.bin", "sampler.bin",
        "custom_checkpoint_0.pkl", "accelerator_step.bin", "random_states_0.pkl"])
    assert acc.checkpoint_stats["bytes"] > 0 and acc.checkpoint_stats["event"] == "save"
    del it

    acc2, _, loader2, sched2 = _port_run(tmp_path, seed=1)
    counter = Counter(0)
    acc2.register_for_checkpointing(counter)
    assert acc2.load_state() == out
    got = _snapshot(acc2)
    for name, p in want["params"].items():
        assert torch.equal(got["params"][name], p), name
        for k, v in want["moments"][name].items():
            assert torch.equal(got["moments"][name][k], v), (name, k)
    assert (got["step"], got["count"]) == (want["step"], want["count"]) == (3, 3)
    assert sched2.state_dict() == sched.state_dict() == {"step_count": 3}
    assert loader2._resume_skip == want_loader["batches_yielded"] == 3
    assert counter.n == 7


def test_rng_states_are_restored(tmp_path):
    import random

    acc, *_ = _port_run(tmp_path)
    set_seed(5)
    out = acc.save_state()
    want = (random.random(), np.random.rand(), float(torch.rand(())))
    acc.load_state(out)
    assert (random.random(), np.random.rand(), float(torch.rand(()))) == want


def test_port_mid_epoch_resume_matches_uninterrupted(tmp_path):
    acc, step, loader, sched = _port_run(tmp_path / "a")
    straight, _ = _steps(acc, step, loader, sched, 9)  # across the epoch boundary

    acc, step, loader, sched = _port_run(tmp_path / "b")
    head, it = _steps(acc, step, loader, sched, 4)
    acc.save_state()
    del it
    acc, step, loader, sched = _port_run(tmp_path / "b", seed=3)
    acc.load_state()
    assert acc.train_state.step == 4 and acc.train_state.optimizer.count == 4
    tail, _ = _steps(acc, step, loader, sched, 5)
    assert head + tail == straight
    assert acc.train_state.step == 9


def _jax_run(tmp_path):
    jcfg = JaxLlamaConfig.tiny(dtype=jnp.float32, **WIDTH)
    module = JaxLlama(jcfg)
    acc = JaxAccelerator(project_config=JaxProjectConfiguration(
        project_dir=str(tmp_path), automatic_checkpoint_naming=True))
    model = JaxModel.from_flax(module, jax.random.key(0), _tokens()[:2, :-1])
    schedule = optax.linear_schedule(**SCHEDULE)
    _, _, loader, sched = acc.prepare(
        model, optax.adamw(schedule), _Spec(jdl.ColumnDataset(ids=_tokens())), schedule)

    def loss_fn(p, b):
        return jax_cross_entropy(module.apply({"params": p}, b["ids"][:, :-1]), b["ids"][:, 1:])

    step = acc.prepare_train_step(loss_fn, max_grad_norm=1.0)
    it, out = iter(loader), []
    for _ in range(5):
        state, m = step(acc.train_state, next(it))
        sched.step()
        out.append((float(m["loss"]), float(m["grad_norm"])))
        if len(out) == 3:
            acc.save_state()
    count = int(acc.train_state.opt_state[0].count)
    return out, count, int(acc.train_state.step), schedule


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    from accelerate_tpu.state import AcceleratorState as JS, GradientState as JG

    jax_metrics, jax_count, jax_step, schedule = _jax_run(tmp_path)
    JS._reset_state()
    JG._reset_state()
    acc, step, loader, sched = _port_run(tmp_path, seed=2)
    acc.load_state()
    st = acc.train_state
    assert st.step == 3 and st.optimizer.count == 3 and sched.state_dict() == {"step_count": 3}
    port_metrics, _ = _steps(acc, step, loader, sched, 2)
    np.testing.assert_allclose(np.array(port_metrics), np.array(jax_metrics[3:]), rtol=1e-4)
    assert (st.step, st.optimizer.count) == (jax_step, jax_count) == (5, 5)
    # The last update's rate: the schedule at count 4, optax's in float32.
    assert st.optimizer.param_groups[0]["lr"] == pytest.approx(float(schedule(4)), rel=1e-6)
    assert sched.get_last_lr() == pytest.approx(float(schedule(5)), rel=1e-6)
    assert acc.project_configuration.iteration == 1


@pytest.mark.parametrize("scan_layers", [True, False])
def test_port_weights_load_in_the_jax_package(tmp_path, scan_layers):
    acc, step, loader, sched = _port_run(tmp_path, scan_layers=scan_layers)
    _steps(acc, step, loader, sched, 1)
    out = acc.save_state()
    module = acc.train_state.model.module
    tree = jax_other.unflatten_state_dict(jax_other.load_sharded_safetensors(out))
    want = jax.tree.map(lambda t: t.detach().numpy(), llama_params_to_flax(
        module.config, dict(module.named_parameters())))
    assert jax.tree.structure(tree) == jax.tree.structure(want)
    jax.tree.map(np.testing.assert_array_equal, tree, want)
    assert ("layers" in tree["model"]) is scan_layers
    jmodule = JaxLlama(JaxLlamaConfig.tiny(dtype=jnp.float32, scan_layers=scan_layers, **WIDTH))
    ids = _tokens()[:2, :-1]
    logits = np.asarray(jmodule.apply({"params": tree}, jnp.asarray(ids)))
    with torch.no_grad():
        port_logits = module(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(port_logits, logits, rtol=1e-5, atol=1e-5)
    back = llama_params_from_flax(module.config, tree)
    assert all(torch.equal(back[n], p) for n, p in module.named_parameters())


def test_total_limit_and_iteration_past_a_restored_checkpoint(tmp_path):
    acc, *_ = _port_run(tmp_path)
    acc.project_configuration.total_limit = 2
    for _ in range(3):
        acc.save_state()
    base = tmp_path / "checkpoints"
    assert sorted(os.listdir(base)) == ["checkpoint_1", "checkpoint_2"]
    (base / "checkpoint_tmp").mkdir()  # not a checkpoint: skipped
    acc, *_ = _port_run(tmp_path)
    acc.project_configuration.total_limit = 2
    assert acc.load_state().endswith("checkpoint_2")
    assert acc.project_configuration.iteration == 3
    assert acc.save_state().endswith("checkpoint_3")
    assert sorted(os.listdir(base)) == ["checkpoint_2", "checkpoint_3", "checkpoint_tmp"]


@pytest.mark.parametrize("state_dict_type", ["SHARDED_STATE_DICT", "FULL_STATE_DICT"])
def test_model_file_layouts(tmp_path, monkeypatch, state_dict_type):
    monkeypatch.setattr(checkpointing, "MAX_SHARD_SIZE", 100_000)
    acc, *_ = _port_run(tmp_path, fsdp_plugin=FullyShardedDataParallelPlugin(
        state_dict_type=state_dict_type))
    want = _snapshot(acc)["params"]
    out = acc.save_state()
    files = sorted(f for f in os.listdir(out) if f.startswith("model"))
    if state_dict_type == "FULL_STATE_DICT":
        assert files == ["model.safetensors"]
    else:
        assert "model.safetensors.index.json" in files and len(files) > 2
        assert files[0].startswith("model-00001-of-")
    jax_flat = jax_other.load_sharded_safetensors(out)
    assert sum(v.nbytes for v in jax_flat.values()) == sum(
        p.numel() * 4 for p in want.values())
    acc, *_ = _port_run(tmp_path, seed=4)
    acc.load_state(out)
    assert all(torch.equal(p, want[n]) for n, p in
               acc.train_state.model.module.named_parameters())


def test_restricted_unpickler_refuses_a_foreign_global(tmp_path):
    path = tmp_path / "evil.pkl"
    path.write_bytes(pickle.dumps({"x": os.getcwd}, protocol=4))
    with pytest.raises(pickle.UnpicklingError, match="refers to posix.getcwd"):
        checkpointing.restricted_load(str(path))
    arrays = {"a": np.arange(6, dtype=np.float32).reshape(2, 3), "s": np.int32(4)}
    for protocol in (2, 5):
        path.write_bytes(pickle.dumps(arrays, protocol=protocol))
        back = checkpointing.restricted_load(str(path))
        np.testing.assert_array_equal(back["a"], arrays["a"])
        assert back["s"] == 4


def test_hooks_custom_objects_and_scheduler_state(tmp_path, caplog):
    acc, step, loader, sched = _port_run(tmp_path)
    _steps(acc, step, loader, sched, 2)
    calls = []
    handle = acc.register_save_state_pre_hook(lambda models, st, d: calls.append(("save", d)))
    acc.register_load_state_pre_hook(lambda models, d: calls.append(("load", d)))
    out = acc.save_state()
    handle.remove()
    acc.save_state()
    acc.load_state(out)
    assert calls == [("save", out), ("load", out)]
    with pytest.raises(ValueError, match="state_dict"):
        acc.register_for_checkpointing(object())
    # The safetensors formats save synchronously with a warning, as the JAX
    # package's do; the files load.
    want = _snapshot(acc)["params"]
    with caplog.at_level(logging.WARNING):
        out = acc.save_state(block=False)
    assert "saves synchronously" in caplog.text
    assert acc.checkpoint_stats["blocking"] and acc._pending_save is None
    acc2, *_ = _port_run(tmp_path, seed=5)
    acc2.load_state(out)
    assert all(torch.equal(p, want[n])
               for n, p in acc2.train_state.model.module.named_parameters())
    assert sched.get_last_lr() == pytest.approx(linear_schedule(**SCHEDULE)(2))


def test_safetensors_files_cross_packages(tmp_path):
    from safetensors.numpy import load_file

    rng = np.random.default_rng(0)
    small = {"w": rng.normal(size=(3, 5)).astype(np.float32),
             "i": np.arange(4, dtype=np.int64), "s": np.float32(2.5)}
    big = {**small, "big": rng.normal(size=(600, 600)).astype(np.float32)}  # > 1 MiB: native
    for name, tensors in (("small", small), ("big", big)):
        port_file, jax_file = str(tmp_path / f"p_{name}"), str(tmp_path / f"j_{name}")
        save_safetensors(tensors, port_file)
        for k, v in load_file(port_file).items():
            np.testing.assert_array_equal(v, tensors[k])
        jax_other.save_safetensors(tensors, jax_file)
        for k, v in load_safetensors(jax_file).items():
            np.testing.assert_array_equal(v.numpy(), tensors[k])
    bf16 = {"h": torch.randn(4, 3).to(torch.bfloat16)}
    save_safetensors(bf16, str(tmp_path / "bf16"))
    assert torch.equal(load_safetensors(str(tmp_path / "bf16"))["h"], bf16["h"])


def test_save_and_load_leave_no_reference_cycles(tmp_path):
    """Nothing a save or load builds waits for the cyclic garbage collector:
    on the card a cycle would hold the checkpoint's device copies (a
    recursive closure in flatten_state_dict once kept 11 GiB after a save)."""
    import gc

    acc, *_ = _port_run(tmp_path)
    out = acc.save_state()
    acc.load_state(out)
    gc.collect()
    gc.disable()
    try:
        acc.save_state(out)
        assert gc.collect() == 0
        acc.load_state(out)
        assert gc.collect() == 0
    finally:
        gc.enable()


# ---------------------------------------------------------------------------
# A port checkpoint resumed by the JAX package
# ---------------------------------------------------------------------------


def _jax_resume(tmp_path, scheduled):
    """The JAX Accelerator with the tiny Llama from other weights, adamw and
    the loader of _port_run: load_state() of the newest checkpoint in
    tmp_path, then two steps. (metrics, step, adam count, the opt_state)."""
    from accelerate_tpu.state import AcceleratorState as JS, GradientState as JG

    JS._reset_state()
    JG._reset_state()
    module = JaxLlama(JaxLlamaConfig.tiny(dtype=jnp.float32, **WIDTH))
    acc = JaxAccelerator(project_config=JaxProjectConfiguration(
        project_dir=str(tmp_path), automatic_checkpoint_naming=True))
    model = JaxModel.from_flax(module, jax.random.key(7), _tokens()[:2, :-1])
    schedule = optax.linear_schedule(**SCHEDULE)
    objs = [model, optax.adamw(schedule if scheduled else LR),
            _Spec(jdl.ColumnDataset(ids=_tokens()))] + ([schedule] if scheduled else [])
    prepared = acc.prepare(*objs)
    loader = prepared[2]

    def loss_fn(p, b):
        return jax_cross_entropy(module.apply({"params": p}, b["ids"][:, :-1]), b["ids"][:, 1:])

    step = acc.prepare_train_step(loss_fn, max_grad_norm=1.0)
    acc.load_state()
    it, out = iter(loader), []
    for _ in range(2):
        _, m = step(acc.train_state, next(it))
        if scheduled:
            prepared[3].step()
        out.append((float(m["loss"]), float(m["grad_norm"])))
    it.close()
    st = acc.train_state
    result = (out, int(st.step), int(st.opt_state[0].count), st.opt_state)
    JS._reset_state()
    JG._reset_state()
    return result


@pytest.mark.parametrize("scheduled", [False, True], ids=["constant", "schedule"])
def test_port_checkpoint_resumes_in_the_jax_package(tmp_path, scheduled):
    """The mirror of test_jax_checkpoint_resumes_in_the_port: the port saves
    after 3 steps (optimizer.bin in optax's structure, unpickled by the JAX
    process into optax's own classes) and takes 2 more; the JAX package's
    load_state reads the checkpoint and its next two losses and grad norms
    are the port's within rtol 1e-4, at the same step and count."""
    acc, step, loader, sched = _port_run(tmp_path, scheduled=scheduled)
    head, it = _steps(acc, step, loader, sched, 3)
    out = acc.save_state()
    tail, _ = _steps(acc, step, loader, sched, 2, it)
    with open(os.path.join(out, "optimizer.bin"), "rb") as f:
        payload = pickle.load(f)  # the JAX process's reader: plain pickle, optax importable
    adam, decay, rate = payload["opt_state"]
    assert type(adam) is optax.ScaleByAdamState and type(decay) is optax.EmptyState
    assert type(rate) is (optax.ScaleByScheduleState if scheduled else optax.EmptyState)
    metrics, jax_step, count, opt_state = _jax_resume(tmp_path, scheduled)
    want = optax.adamw(LR).init({"p": jnp.zeros(2)}) if not scheduled else optax.adamw(
        optax.linear_schedule(**SCHEDULE)).init({"p": jnp.zeros(2)})
    assert jax.tree.structure(opt_state, is_leaf=lambda x: isinstance(x, dict)) == \
        jax.tree.structure(want, is_leaf=lambda x: isinstance(x, dict))
    np.testing.assert_allclose(np.array(metrics), np.array(tail), rtol=1e-4)
    assert (jax_step, count) == (acc.train_state.step, acc.train_state.optimizer.count) == (5, 5)
    # The port still reads what it writes, and its older plain-dict form.
    back = checkpointing.restricted_load(os.path.join(out, "optimizer.bin"))
    assert checkpointing._opt_payload_parts(back["opt_state"])[0] == 3
    old = {"count": np.int32(3), "mu": {}, "nu": {}}
    assert checkpointing._opt_payload_parts(old) == (3, {}, {})


def test_jax_rng_entry_survives_a_port_round_trip(tmp_path):
    """random_states_<rank>.pkl: the JAX package's key registry (seed and
    stream counters) read by the port, written back by the port, restored
    by the JAX package unchanged; without one the port writes the state
    set_seed gives the registry."""
    from accelerate_tpu.utils import random as jax_random

    from accelerate_tpu_torch.utils import random as port_random

    jax_random.set_seed(7)
    for stream in ("dropout", "dropout", "params"):
        jax_random.next_rng_key(stream)
    want = jax_random.rng_state()["jax"]
    assert want == {"seed": 7, "counters": {"dropout": 2, "params": 1}}
    path = tmp_path / "random_states_0.pkl"
    path.write_bytes(pickle.dumps(jax_random.rng_state()))
    port_random.load_rng_state(checkpointing.restricted_load(str(path)))
    checkpointing._dump(port_random.rng_state(), str(path))
    jax_random.set_seed(0)
    with open(path, "rb") as f:
        jax_random.load_rng_state(pickle.load(f))
    assert jax_random.rng_state()["jax"] == want
    set_seed(11)
    assert port_random.rng_state()["jax"] == {"seed": 11, "counters": {}}


# ---------------------------------------------------------------------------
# DISTRIBUTED_STATE_DICT without a process group
# ---------------------------------------------------------------------------


def _dcp_run(tmp_path, seed=0, **kw):
    return _port_run(tmp_path, seed=seed, fsdp_plugin=FullyShardedDataParallelPlugin(
        state_dict_type="DISTRIBUTED_STATE_DICT"), **kw)


def test_distributed_state_dict_round_trip(tmp_path):
    """Every tensor, count and state back; the directory holds DCP's files
    in place of model.safetensors and optimizer.bin, and the next steps
    are the uninterrupted run's."""
    acc, step, loader, sched = _dcp_run(tmp_path)
    _, it = _steps(acc, step, loader, sched, 3)
    want = _snapshot(acc)
    out = acc.save_state()
    assert sorted(os.listdir(out)) == sorted([
        "distributed_state_torch", "scheduler.bin", "sampler.bin", "accelerator_step.bin",
        "random_states_0.pkl"])
    assert ".metadata" in os.listdir(os.path.join(out, "distributed_state_torch"))
    stats = acc.checkpoint_stats
    assert stats["format"] == "dcp" and stats["blocking"] and stats["bytes"] > 0
    straight, _ = _steps(acc, step, loader, sched, 2, it)

    acc2, step2, loader2, sched2 = _dcp_run(tmp_path, seed=1)
    assert acc2.load_state() == out and acc2.checkpoint_stats["format"] == "dcp"
    got = _snapshot(acc2)
    for name, p in want["params"].items():
        assert torch.equal(got["params"][name], p), name
        for k, v in want["moments"][name].items():
            assert torch.equal(got["moments"][name][k], v), (name, k)
    assert (got["step"], got["count"]) == (3, 3)
    assert _steps(acc2, step2, loader2, sched2, 2)[0] == straight


def test_distributed_state_dict_names_are_the_flax_trees():
    from accelerate_tpu_torch.checkpointing import _flax_name
    from accelerate_tpu_torch.utils.other import flatten_state_dict

    module = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32, **WIDTH))
    names = {_flax_name(module, n) for n, _ in module.named_parameters()}
    flax = flatten_state_dict(llama_params_to_flax(
        LlamaConfig.tiny(dtype=torch.float32, scan_layers=False, **WIDTH),
        dict(module.named_parameters())))
    assert names == set(flax)


def test_async_distributed_save_persists_while_training_goes_on(tmp_path):
    """save_state(block=False) returns once the state is staged: two steps
    run before wait_for_checkpoint, and the load gives the state at the
    save. A second asynchronous save waits for the first; the next save,
    load_state and end_training drain the one in flight."""
    acc, step, loader, sched = _dcp_run(tmp_path)
    _, it = _steps(acc, step, loader, sched, 2)
    want = _snapshot(acc)
    first = acc.save_state(block=False)
    assert acc._pending_save is not None and not acc.checkpoint_stats["blocking"]
    assert acc.checkpoint_stats["staged_bytes"] > 0
    _, it = _steps(acc, step, loader, sched, 2, it)
    acc.wait_for_checkpoint()
    assert acc._pending_save is None and acc.checkpoint_stats["bytes"] > 0
    after = _snapshot(acc)
    second = acc.save_state(block=False)
    third = acc.save_state(block=False)  # waits for the second
    acc.end_training()
    assert acc._pending_save is None and first != second != third

    for out, snap in ((first, want), (second, after), (third, after)):
        acc2, *_ = _dcp_run(tmp_path, seed=3)
        acc2.load_state(out)
        got = _snapshot(acc2)
        assert all(torch.equal(got["params"][n], p) for n, p in snap["params"].items())
        assert all(torch.equal(got["moments"][n][k], v) for n, m in snap["moments"].items()
                   for k, v in m.items())
        assert (got["step"], got["count"]) == (snap["step"], snap["count"])


def test_async_save_failure_raises_in_wait_for_checkpoint(tmp_path, monkeypatch):
    """A write that fails in the background surfaces in wait_for_checkpoint
    as CheckpointSaveError; the save is then no longer in flight."""
    from concurrent.futures import Future

    import torch.distributed.checkpoint as dcp

    from accelerate_tpu_torch import CheckpointSaveError, TelemetryKwargs

    def failing(state, **kw):
        future = Future()
        future.set_exception(OSError("disk full"))
        return future

    monkeypatch.setattr(dcp, "async_save", failing)
    acc, *_ = _dcp_run(tmp_path, kwargs_handlers=[TelemetryKwargs(log_every=0)])
    acc.save_state(block=False)
    with pytest.raises(CheckpointSaveError, match="disk full"):
        acc.wait_for_checkpoint()
    assert acc._pending_save is None
    acc.wait_for_checkpoint()
    assert acc.telemetry._ckpt["async_errors"] == 1
    acc.end_training()
    assert acc._dcp_stager is None


def test_distributed_state_dict_refuses_orbax_and_more_than_one_model(tmp_path):
    """The JAX package's orbax directory is not read (the safetensors
    formats are the interchange); DISTRIBUTED_STATE_DICT holds one model."""
    acc, *_ = _dcp_run(tmp_path)
    orbax = tmp_path / "jax_ckpt"
    (orbax / "distributed_state").mkdir(parents=True)
    with pytest.raises(ValueError, match="orbax.*FULL_STATE_DICT or SHARDED_STATE_DICT"):
        acc.load_state(str(orbax))
    second = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32, **WIDTH))
    acc.prepare(Model(second), adamw(LR))
    with pytest.raises(NotImplementedError, match="single prepared model"):
        acc.save_state()


# ---------------------------------------------------------------------------
# Checkpoints of the other families in the JAX package's flax trees
# ---------------------------------------------------------------------------


def _family_setups():
    """family -> (port module and config, JAX module, port loss, JAX loss,
    batch maker). Mixtral at 4 experts and capacity factor 0.5 (tokens drop),
    GPT-2 and T5 at their tiny widths, all fp32."""
    from accelerate_tpu.models import gpt2 as jgpt2
    from accelerate_tpu.models import moe as jmoe
    from accelerate_tpu.models import t5 as jt5
    from accelerate_tpu_torch.models import (
        GPT2Config, GPT2LMHeadModel, MixtralConfig, MixtralForCausalLM, T5Config,
        T5ForConditionalGeneration, moe_cross_entropy_loss, shift_tokens_right,
        t5_cross_entropy_loss)

    def causal(rng):
        ids = rng.integers(0, 256, (8, 17)).astype(np.int64)
        return {"x": ids[:, :-1], "y": ids[:, 1:]}

    def seq2seq(rng):
        return {"x": rng.integers(2, 256, (8, 10)).astype(np.int64),
                "y": rng.integers(2, 256, (8, 6)).astype(np.int64)}

    moe_kw = dict(num_local_experts=4, capacity_factor=0.5)
    return {
        "mixtral": (MixtralForCausalLM(MixtralConfig.tiny(dtype=torch.float32, **moe_kw)),
                    jmoe.MixtralForCausalLM(jmoe.MixtralConfig.tiny(
                        dtype=jnp.float32, attention_impl="native", **moe_kw)),
                    lambda m, b: moe_cross_entropy_loss(m, b["x"], b["y"]),
                    lambda mod, p, b: jmoe.moe_cross_entropy_loss(mod, p, b["x"], b["y"]),
                    causal),
        "gpt2": (GPT2LMHeadModel(GPT2Config.tiny(dtype=torch.float32)),
                 jgpt2.GPT2LMHeadModel(jgpt2.GPT2Config.tiny(dtype=jnp.float32)),
                 lambda m, b: cross_entropy_loss(m(b["x"]), b["y"]),
                 lambda mod, p, b: jax_cross_entropy(mod.apply({"params": p}, b["x"]), b["y"]),
                 causal),
        "t5": (T5ForConditionalGeneration(T5Config.tiny(dtype=torch.float32)),
               jt5.T5ForConditionalGeneration(jt5.T5Config.tiny(dtype=jnp.float32)),
               lambda m, b: t5_cross_entropy_loss(m(b["x"], shift_tokens_right(b["y"])), b["y"]),
               lambda mod, p, b: jt5.t5_cross_entropy_loss(
                   mod.apply({"params": p}, b["x"], jt5.shift_tokens_right(b["y"])), b["y"]),
               seq2seq),
    }


def _family_weights(module, seed):
    rng = np.random.default_rng(seed)
    return {n: torch.from_numpy((rng.standard_normal(p.shape) * (0.1 if p.dim() == 1 else 0.05)
                                 + (1.0 if p.dim() == 1 and not n.endswith("bias") else 0.0))
                                .astype(np.float32))
            for n, p in module.state_dict().items()}


def _flat_tree(tree) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_family_run(module, loss, seed):
    from accelerate_tpu_torch.models import convert

    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    module.load_state_dict(_family_weights(module, seed))
    acc = Accelerator(cpu=True)
    acc.prepare(Model(module), adamw(LR))
    step = acc.prepare_train_step(loss, max_grad_norm=1.0)

    def state_trees():
        """(params, mu, nu) as flax trees of numpy arrays."""
        conv = convert.flax_converter(module)
        opt = acc.train_state.optimizer
        named = dict(module.named_parameters())
        trees = [{n: p.detach() for n, p in named.items()}]
        trees += [{n: opt.state[p][k] for n, p in named.items()} for k in ("exp_avg",
                                                                           "exp_avg_sq")]
        return [_flat_tree(jax.tree.map(lambda t: t.numpy(), conv.to_flax(module.config, t)))
                for t in trees]

    def run(batch):
        _, m = step(acc.train_state, {k: torch.from_numpy(v) for k, v in batch.items()})
        return float(m["loss"])

    return acc, run, state_trees


def _jax_family_run(jmodule, params, loss):
    from accelerate_tpu.state import AcceleratorState as JS, GradientState as JG

    JS._reset_state()
    JG._reset_state()
    acc = JaxAccelerator()
    acc.prepare(JaxModel(module=jmodule, params=params), optax.adamw(LR))
    step = acc.prepare_train_step(lambda p, b: loss(jmodule, p, b), max_grad_norm=1.0)

    def state_trees():
        st = acc.train_state
        return [_flat_tree(t) for t in (st.params, st.opt_state[0].mu, st.opt_state[0].nu)]

    def run(batch):
        _, m = step(acc.train_state, {k: jnp.asarray(v.astype(np.int32))
                                      for k, v in batch.items()})
        return float(m["loss"])

    return acc, run, state_trees


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
@pytest.mark.parametrize("family", ["mixtral", "gpt2", "t5"])
def test_other_families_resume_across_packages(tmp_path, family, direction):
    """model.safetensors and optimizer.bin in the JAX package's flax trees
    for Mixtral (a module of its own, no Llama subclass), GPT-2 and T5: a
    checkpoint saved after two steps by one package is loaded by the other
    (whose model started from other weights); parameters and AdamW's
    moments come back within rtol 1e-6 and the next step's loss within
    1e-4 of the saving package's."""
    from accelerate_tpu_torch.models import convert

    module, jmodule, port_loss, jax_loss, batch_of = _family_setups()[family]
    rng = np.random.default_rng(6)
    batches = [batch_of(rng) for _ in range(3)]
    flax_params = lambda seed: jax.tree.map(  # noqa: E731
        lambda t: t.numpy(), convert.flax_converter(module).to_flax(
            module.config, _family_weights(module, seed)))
    ckpt = str(tmp_path / "ckpt")
    port = _port_family_run(module, port_loss, seed=0 if direction == "port_to_jax" else 1)
    jaxr = _jax_family_run(jmodule, flax_params(1 if direction == "port_to_jax" else 0),
                           jax_loss)
    (src_acc, src_run, src_trees), (dst_acc, dst_run, dst_trees) = (
        (port, jaxr) if direction == "port_to_jax" else (jaxr, port))
    for b in batches[:2]:
        src_run(b)
    src_acc.save_state(ckpt)
    dst_acc.load_state(ckpt)
    for want, got in zip(src_trees(), dst_trees()):
        assert want.keys() == got.keys()
        for name in want:
            np.testing.assert_allclose(got[name], want[name], rtol=1e-6, atol=1e-9,
                                       err_msg=name)
    np.testing.assert_allclose(dst_run(batches[2]), src_run(batches[2]), rtol=1e-4)
