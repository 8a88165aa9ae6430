"""The rest of the port's Accelerator surface against the JAX package's: the
out-of-memory retry (``utils/memory.py``), the ``memory_utils`` alias,
``logging.py``, ``autocast``, ``save_model``/``get_state_dict``/``save``,
``free_memory``, triggers, the process helpers on one process, the
gradient-accumulation plugin, the refusals of the imperative loop, the
properties and ``prepare_model``/``prepare_optimizer``, and the helpers of
``utils/operations.py`` and ``utils/other.py``.
"""

import gc
import importlib
import json
import logging
import os
import sys
import weakref

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu import Model as JaxModel
from accelerate_tpu.models import LlamaConfig as JaxLlamaConfig
from accelerate_tpu.models import LlamaForCausalLM as JaxLlama
from accelerate_tpu.utils import GradientAccumulationPlugin as JaxPlugin
from accelerate_tpu.utils import memory as jax_memory
from accelerate_tpu.utils.other import load_safetensors as jax_load_safetensors
from accelerate_tpu_torch import (
    AcceleratedScheduler,
    Accelerator,
    ColumnDataset,
    GradientAccumulationPlugin,
    Model,
    adamw,
    find_executable_batch_size,
    linear_schedule,
)
from accelerate_tpu_torch import logging as port_logging
from accelerate_tpu_torch.models import LlamaConfig, LlamaForCausalLM, llama_params_from_flax
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState
from accelerate_tpu_torch.utils import memory
from accelerate_tpu_torch.utils.other import load_safetensors


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the driver runs several test processes at once,
    and torch's spinning thread pools would contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def reset_state():
    yield
    from accelerate_tpu.state import AcceleratorState as JS
    from accelerate_tpu.state import GradientState as JG

    for cls in (AcceleratorState, GradientState, PartialState, JS, JG):
        cls._reset_state()


# ---------------------------------------------------------------------------
# find_executable_batch_size and the memory helpers
# ---------------------------------------------------------------------------


def _tried(find, oom, fits_at=16, start=64):
    tried = []

    @find(starting_batch_size=start)
    def run(batch_size, scale):
        tried.append(batch_size)
        if batch_size > fits_at:
            raise oom()
        return batch_size * scale

    return run(3), tried


def test_find_executable_batch_size_halves_as_the_jax_package_does():
    got = _tried(find_executable_batch_size, lambda: torch.OutOfMemoryError("CUDA out of memory"))
    want = _tried(jax_memory.find_executable_batch_size,
                  lambda: RuntimeError("RESOURCE_EXHAUSTED: Out of memory"))
    assert got == want == (48, [64, 32, 16])
    # The CUDA runtime's and cuBLAS's messages count as allocation failures.
    for message in ("CUDA error: out of memory", "CUBLAS_STATUS_ALLOC_FAILED when calling"):
        assert _tried(find_executable_batch_size, lambda: RuntimeError(message))[1] == [
            64, 32, 16]


def test_find_executable_batch_size_reraises_other_errors_and_refuses_a_passed_size():
    @find_executable_batch_size(starting_batch_size=8)
    def bad(batch_size):
        raise ValueError("not memory")

    with pytest.raises(ValueError, match="not memory"):
        bad()

    @find_executable_batch_size(starting_batch_size=8)
    def train(batch_size, lr):
        return batch_size

    with pytest.raises(TypeError, match="Batch size was passed"):
        train(8, 1e-3)

    @find_executable_batch_size(starting_batch_size=2)
    def never(batch_size):
        raise torch.OutOfMemoryError("CUDA out of memory")

    with pytest.raises(RuntimeError, match="reached zero"):
        never()


def test_find_executable_batch_size_frees_the_failed_attempt_first():
    """The failed call's tensors, held by its traceback, are gone before the
    next call runs."""
    refs = []

    @find_executable_batch_size(starting_batch_size=4)
    def run(batch_size):
        alive = [r() is not None for r in refs]
        activations = torch.ones(batch_size, 1024)
        refs.append(weakref.ref(activations))
        if batch_size > 1:
            raise torch.OutOfMemoryError("CUDA out of memory")
        return alive

    assert run() == [False, False]


def test_should_reduce_batch_size_and_memory_stats():
    assert memory.should_reduce_batch_size(torch.OutOfMemoryError("x"))
    assert memory.should_reduce_batch_size(RuntimeError("CUDA out of memory. Tried to allocate"))
    assert not memory.should_reduce_batch_size(RuntimeError("shape mismatch"))
    assert not memory.should_reduce_batch_size(ValueError("CUDA out of memory"))
    assert memory.get_device_memory_stats("cpu") == {}
    assert memory.release_memory(torch.ones(2), [1]) == [None, None]


def test_memory_utils_alias_warns():
    sys.modules.pop("accelerate_tpu_torch.memory_utils", None)
    with pytest.warns(FutureWarning, match="accelerate_tpu_torch.utils.memory"):
        alias = importlib.import_module("accelerate_tpu_torch.memory_utils")
    assert alias.find_executable_batch_size is memory.find_executable_batch_size


# ---------------------------------------------------------------------------
# Logging and autocast
# ---------------------------------------------------------------------------


def test_get_logger_main_process_only_and_warning_once(caplog, monkeypatch):
    logger = port_logging.get_logger("surface_test", log_level="INFO")
    PartialState._reset_state()
    with pytest.raises(RuntimeError, match="initialize the accelerate state"):
        logger.info("before any state")
    PartialState(cpu=True)
    monkeypatch.setattr(port_logging, "_WARNED_ONCE", set())
    with caplog.at_level(logging.INFO, logger="surface_test"):
        logger.info("main %d", 1)
        logger.info("everywhere", main_process_only=False)
        logger.info("in order", main_process_only=False, in_order=True)
        for _ in range(3):
            logger.warning_once("once %s", "a")
        logger.warning_once("once %s", "b")
        monkeypatch.setattr(PartialState, "is_main_process", property(lambda self: False))
        logger.info("not on the main process")
        logger.info("on every process", main_process_only=False)
    assert [r.getMessage() for r in caplog.records] == [
        "main 1", "everywhere", "in order", "once a", "once b", "on every process"]
    assert logging.getLogger("surface_test").level == logging.INFO


def test_autocast_warns_once_and_changes_nothing(caplog, monkeypatch):
    monkeypatch.setattr(port_logging, "_WARNED_ONCE", set())
    acc = Accelerator(cpu=True, mixed_precision="bf16")
    with caplog.at_level(logging.WARNING):
        for _ in range(2):
            with acc.autocast():
                x = torch.ones(2, 2) @ torch.ones(2, 2)
    assert x.dtype == torch.float32
    warned = [r for r in caplog.records if "autocast" in r.getMessage()]
    assert len(warned) == 1 and "bf16" in warned[0].getMessage()


# ---------------------------------------------------------------------------
# save_model, get_state_dict, save
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_tiny():
    module = JaxLlama(JaxLlamaConfig.tiny(dtype=jnp.float32))
    ids = np.zeros((8, 8), np.int32)
    params = jax.tree.map(np.asarray, JaxModel.from_flax(module, jax.random.key(0), ids).params)
    return module, params


def _port_model(params):
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    module = LlamaForCausalLM(cfg)
    module.load_state_dict(llama_params_from_flax(cfg, params))
    return module


@pytest.mark.parametrize("max_shard_size", ["5GB", 400_000])
def test_save_model_writes_the_jax_packages_files(jax_tiny, tmp_path, max_shard_size):
    module, params = jax_tiny
    jacc = JaxAccelerator()
    jmodel = JaxModel(module=module, params=jax.tree.map(jnp.asarray, params))
    jacc.prepare(jmodel, optax.adamw(1e-3))
    jacc.save_model(jmodel, str(tmp_path / "jax"), max_shard_size=max_shard_size)
    want_state = jacc.get_state_dict(jmodel)

    acc = Accelerator(cpu=True)
    model, _ = acc.prepare(Model(_port_model(params)), adamw(1e-3))
    acc.save_model(model, str(tmp_path / "port"), max_shard_size=max_shard_size)
    got_state = acc.get_state_dict(model)

    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    assert len(names) == (1 if max_shard_size == "5GB" else 6)  # 5 shards and the index
    assert got_state.keys() == want_state.keys()
    for key, want in want_state.items():
        np.testing.assert_array_equal(got_state[key].numpy(), np.asarray(want), err_msg=key)
    for name in names:
        if name.endswith(".json"):  # the index: the same shard of every key
            assert json.loads((tmp_path / "port" / name).read_text()) == json.loads(
                (tmp_path / "jax" / name).read_text())
            continue
        got = load_safetensors(str(tmp_path / "port" / name))
        want = jax_load_safetensors(str(tmp_path / "jax" / name))
        assert sorted(got) == sorted(want), name
        for key in want:
            np.testing.assert_array_equal(got[key].numpy(), want[key], err_msg=key)
    with pytest.raises(ValueError, match="safetensors"):
        acc.save_model(model, str(tmp_path / "x"), safe_serialization=False)


def test_save_writes_safetensors_or_a_torch_pickle(tmp_path):
    acc = Accelerator(cpu=True)
    flat = {"a": torch.arange(3.0), "b": torch.ones(2, 2)}
    acc.save(flat, str(tmp_path / "flat.safetensors"), safe_serialization=True)
    got = load_safetensors(str(tmp_path / "flat.safetensors"))
    assert all(torch.equal(got[k], flat[k]) for k in flat)
    acc.save({"step": 3, "t": torch.ones(1)}, str(tmp_path / "obj.pt"))
    assert torch.load(str(tmp_path / "obj.pt"))["step"] == 3


# ---------------------------------------------------------------------------
# free_memory, the refusals, triggers and the process helpers
# ---------------------------------------------------------------------------


def test_free_memory_drops_every_reference():
    acc = Accelerator(cpu=True)
    module = torch.nn.Linear(4, 2)
    model, opt = acc.prepare(Model(module), adamw(1e-3))
    refs = [weakref.ref(module), weakref.ref(opt), weakref.ref(opt.optimizer)]
    acc.backward(lambda m, x: m(x).sum(), torch.ones(3, 4))
    acc.clip_grad_norm_(None, 1.0)
    model, opt = acc.free_memory(model, opt)
    del module
    gc.collect()
    assert (model, opt) == (None, None) and all(r() is None for r in refs)
    assert acc.step == 0 and acc._max_grad_norm is None
    with pytest.raises(RuntimeError, match="prepare"):
        acc.train_state


def test_backward_takes_a_loss_function_and_value_clipping_raises():
    acc = Accelerator(cpu=True)
    model, opt = acc.prepare(Model(torch.nn.Linear(4, 2)), adamw(1e-3))
    loss = model(torch.ones(1, 4)).sum()
    with pytest.raises(TypeError, match=r"backward\(loss_fn, batch\)"):
        acc.backward(loss)
    with pytest.raises(NotImplementedError, match="clip_grad_norm_"):
        acc.clip_grad_value_(model.parameters(), 0.5)
    with pytest.raises(NotImplementedError, match="L2"):
        acc.clip_grad_norm_(None, 1.0, norm_type=1.0)
    assert acc.clip_grad_norm_(None, 1.0) is None  # nothing accumulated yet
    loss, aux = acc.backward(lambda m, x: (m(x).sum(), "aux"), np.ones((1, 4), np.float32),
                             has_aux=True)
    assert aux == "aux" and loss.requires_grad is False


def test_trigger_and_process_helpers_on_one_process():
    acc = Accelerator(cpu=True)
    assert acc.check_trigger() is False
    acc.set_trigger()
    assert acc.check_trigger() is True and acc.check_trigger() is False
    calls = []
    acc.on_main_process(lambda: calls.append("main"))()
    acc.on_local_main_process(lambda: calls.append("local"))()
    acc.on_last_process(lambda: calls.append("last"))()
    acc.on_process(process_index=0)(lambda: calls.append("p0"))()
    acc.on_process(lambda: calls.append("p1"), process_index=1)()
    acc.on_local_process(local_process_index=0)(lambda: calls.append("l0"))()
    with acc.main_process_first():
        calls.append("first")
    with acc.local_main_process_first():
        calls.append("local first")
    assert calls == ["main", "local", "last", "p0", "l0", "first", "local first"]
    with acc.split_between_processes([1, 2, 3], apply_padding=True) as share:
        assert share == [1, 2, 3]


def test_print_only_on_the_local_main_process(capsys, monkeypatch):
    acc = Accelerator(cpu=True)
    acc.print("shown")
    monkeypatch.setattr(PartialState, "is_local_main_process", property(lambda self: False))
    acc.print("hidden")
    assert capsys.readouterr().out == "shown\n"


def test_join_uneven_inputs_overrides_even_batches_inside_only():
    acc = Accelerator(cpu=True)

    class Spec:
        dataset, batch_size, sampler, drop_last = ColumnDataset(x=np.arange(6)), 2, None, False

    loader = acc.prepare(Spec())
    assert loader.batch_sampler.even_batches is True
    with acc.join_uneven_inputs([], even_batches=False):
        assert loader.batch_sampler.even_batches is False
    assert loader.batch_sampler.even_batches is True


# ---------------------------------------------------------------------------
# The plugin, the scheduler and the refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(num_steps=4), dict(num_steps=2, sync_each_batch=True),
                                dict(adjust_scheduler=False, sync_with_dataloader=False)])
def test_plugin_kwargs_match_the_jax_plugin(kw):
    plugin = GradientAccumulationPlugin(**kw)
    assert plugin.to_kwargs() == JaxPlugin(**kw).to_kwargs() == kw
    acc = Accelerator(cpu=True, gradient_accumulation_plugin=plugin,
                      gradient_accumulation_steps=7)  # the plugin decides
    gs = acc.gradient_state
    assert (gs.num_steps, gs.adjust_scheduler, gs.sync_with_dataloader, gs.sync_each_batch) == (
        kw.get("num_steps", 1), kw.get("adjust_scheduler", True),
        kw.get("sync_with_dataloader", True), kw.get("sync_each_batch", False))


def test_scheduler_counts_only_applied_steps():
    acc = Accelerator(cpu=True, gradient_accumulation_steps=2)
    schedule = linear_schedule(1.0, 0.0, 10)
    model, opt, sched = acc.prepare(Model(torch.nn.Linear(2, 1)), adamw(schedule), schedule)
    counts = []
    for _ in range(4):
        with acc.accumulate(model):
            sched.step()
            counts.append(sched.state_dict()["step_count"])
    assert counts == [0, 1, 1, 2]
    opt._is_overflow = True
    with acc.accumulate(model), acc.accumulate(model):
        sched.step()
    assert sched.state_dict()["step_count"] == 2 and acc.optimizer_step_was_skipped
    free = AcceleratedScheduler(schedule, optimizers=[opt], step_with_optimizer=False)
    free.step()
    assert free.get_last_lr() == schedule(1)
    acc2_sched = Accelerator(cpu=True, step_scheduler_with_optimizer=False).prepare_scheduler(
        schedule)
    assert acc2_sched.step_with_optimizer is False


def test_optimizer_zero_grad_and_step_wait_for_the_window():
    acc = Accelerator(cpu=True, gradient_accumulation_steps=2)
    model, opt = acc.prepare(Model(torch.nn.Linear(2, 1)), adamw(1e-1))
    before = [p.detach().clone() for p in model.parameters()]
    with acc.accumulate(model):
        acc.backward(lambda m, x: m(x).sum(), torch.ones(1, 2))
        opt.step()
        opt.zero_grad()
    assert all(p.grad is not None for p in model.parameters())
    assert all(torch.equal(p, b) for p, b in zip(model.parameters(), before))
    with acc.accumulate(model):
        acc.backward(lambda m, x: m(x).sum(), torch.ones(1, 2))
        opt.step()
        opt.zero_grad()
    assert all(p.grad is None for p in model.parameters())
    assert not any(torch.equal(p, b) for p, b in zip(model.parameters(), before))
    assert acc.train_state.step == 1 and acc.train_state.optimizer.count == 1


# ---------------------------------------------------------------------------
# The rest of the surface: properties, prepare_model/prepare_optimizer and
# the helpers of utils/operations.py and utils/other.py
# ---------------------------------------------------------------------------


def test_properties_match_a_fresh_jax_accelerator():
    from accelerate_tpu import DataLoaderConfiguration as JaxDLC
    from accelerate_tpu import ProjectConfiguration as JaxProject
    from accelerate_tpu_torch import DataLoaderConfiguration, ProjectConfiguration

    jacc = JaxAccelerator(dataloader_config=JaxDLC(dispatch_batches=False,
                                                   use_seedable_sampler=False),
                          project_config=JaxProject(iteration=3))
    acc = Accelerator(cpu=True, dataloader_config=DataLoaderConfiguration(
        dispatch_batches=False, use_seedable_sampler=False),
        project_config=ProjectConfiguration(iteration=3))
    for name in ("dispatch_batches", "use_seedable_sampler", "non_blocking", "save_iteration",
                 "tensor_parallel_rank", "pipeline_parallel_rank"):
        assert getattr(acc, name) == getattr(jacc, name), name
    assert acc.mesh is None  # no process group
    assert acc.parallelism_config is acc.state.parallelism_config
    # dp_shard fills the world: the port's processes, the JAX package's devices.
    assert acc.parallelism_config.dp_shard_size == acc.num_processes == 1
    assert jacc.parallelism_config.dp_shard_size == len(jax.devices())


def test_prepare_model_then_prepare_optimizer_give_prepares_step():
    """The two halves in turn give the step of ``prepare(model, opt)``."""
    def run(split):
        _reset_all()
        torch.manual_seed(0)
        acc = Accelerator(cpu=True)
        model = Model(torch.nn.Linear(4, 2))
        if split:
            assert acc.prepare_model(model) is model and acc.prepare_model(model) is model
            opt = acc.prepare_optimizer(adamw(1e-2))
        else:
            model, opt = acc.prepare(model, adamw(1e-2))
        step = acc.prepare_train_step(lambda m, b: (m(b["x"]) ** 2).mean(), max_grad_norm=1.0)
        x = torch.from_numpy(np.random.default_rng(0).standard_normal((3, 4), np.float32))
        metrics = [step(acc.train_state, {"x": x})[1] for _ in range(2)]
        return ([float(m["loss"]) for m in metrics], model.module.weight.detach().clone(),
                opt.optimizer is acc.train_state.optimizer)

    split, whole = run(True), run(False)
    assert split[0] == whole[0] and torch.equal(split[1], whole[1]) and split[2] and whole[2]
    _reset_all()
    with pytest.raises(ValueError, match="prepare_model"):
        Accelerator(cpu=True).prepare_optimizer(adamw(1e-2))


def _reset_all():
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()


def test_structure_helpers_match_jax():
    from collections import namedtuple

    from accelerate_tpu.utils import operations as jops
    from accelerate_tpu_torch.utils import operations as ops

    Pair = namedtuple("Pair", "a b")
    rng = np.random.default_rng(5)
    data = {"x": rng.standard_normal((4, 3)).astype(np.float16), "ids": np.arange(4),
            "pair": Pair(np.ones((4, 2), np.float64), [np.zeros((4,), np.float32)]), "tag": "t"}
    tdata = {"x": torch.from_numpy(data["x"]), "ids": torch.from_numpy(data["ids"]),
             "pair": Pair(torch.from_numpy(data["pair"].a), [torch.zeros(4)]), "tag": "t"}
    jdata = jax.tree.map(lambda x: x if isinstance(x, str) else jnp.asarray(x), data)
    assert ops.get_shape(tdata) == jops.get_shape(jdata)
    assert ops.listify(tdata) == jops.listify(jdata)
    assert ops.listify(data) == jops.listify(jdata)
    sliced, jsliced = ops.iterate_over_batch(tdata, 1, 3), jops.iterate_over_batch(jdata, 1, 3)
    assert isinstance(sliced["pair"], Pair) and ops.listify(sliced) == jops.listify(jsliced)
    fp32 = ops.convert_to_fp32(tdata)
    jfp32 = jops.convert_to_fp32(jdata)
    assert fp32["x"].dtype == torch.float32 and str(jfp32["x"].dtype) == "float32"
    assert fp32["ids"].dtype == torch.int64 and fp32["pair"].a.dtype == torch.float32
    assert ops.convert_to_fp32(data)["pair"].a.dtype == np.float32
    assert ops.listify(fp32) == jops.listify(jfp32)
    forward = ops.convert_outputs_to_fp32(lambda x: (x.half(), {"y": x.bfloat16()}))
    out = forward(torch.ones(2))
    assert out[0].dtype == out[1]["y"].dtype == torch.float32
    assert ops.honor_type(Pair(1, 2), iter([3, 4])) == jops.honor_type(Pair(1, 2), iter([3, 4]))
    Accelerator(cpu=True)  # the device the helpers place on
    structure = ops.get_data_structure(tdata)
    assert structure["x"] == ops.TensorInformation((4, 3), torch.float16)
    zeros = ops.initialize_tensors(structure)
    assert zeros["x"].shape == (4, 3) and zeros["x"].dtype == torch.float16
    assert not zeros["pair"].b[0].any() and zeros["tag"] == "t"
    with pytest.raises(TypeError, match="Unsupported type"):
        ops.recursively_apply(lambda t: t, {"a": "s"}, error_on_other_type=True)
    sent = ops.send_to_device(data, "cpu", skip_keys=["ids"])
    assert torch.is_tensor(sent["x"]) and isinstance(sent["ids"], np.ndarray)
    assert torch.is_tensor(ops.copy_tensor_to_devices(data)["pair"].a)


def test_verify_operation_passes_alone_and_in_debug_mode(monkeypatch):
    from accelerate_tpu_torch.utils import operations as ops

    monkeypatch.setenv("ACCELERATE_DEBUG_MODE", "1")
    assert PartialState(cpu=True).debug

    @ops.verify_operation
    def collective(tensor):
        return tensor

    assert collective.__name__ == "collective"
    assert collective(torch.ones(2)).shape == (2,)  # one process: nothing to compare
    assert issubclass(ops.DistributedOperationException, Exception)


def test_other_helpers_match_jax():
    from accelerate_tpu.utils import other as jother
    from accelerate_tpu_torch.utils import other

    for size in (0, 512, 1536, 3 * 2**20 + 5, 7.5 * 2**40, 2**60):
        assert other.convert_bytes(size) == jother.convert_bytes(size)
    src = {"a": {"b": 1, "c": {"d": 2}}, "e": 3}
    assert other.merge_dicts(src, {"a": {"x": 0}, "f": 4}) == jother.merge_dicts(
        src, {"a": {"x": 0}, "f": 4})
    port = other.get_free_port()
    assert 0 < port < 65536
    model = Model(torch.nn.Linear(2, 2))
    assert other.extract_model_from_parallel(model) is model
    Accelerator(cpu=True)
    other.wait_for_everyone()  # alone: returns
