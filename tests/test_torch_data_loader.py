"""The port's data loading (accelerate_tpu_torch.data_loader) against the JAX
package's (accelerate_tpu.data_loader) on the same inputs: the same sample
indices per process, epoch and seed, the same mid-epoch state, and batches
as torch tensors on the asked device. The cases of tests/test_data_loader.py
are mirrored here for the port.
"""

import numpy as np
import pytest
import torch

import accelerate_tpu.data_loader as jdl
import accelerate_tpu_torch.data_loader as tdl
from accelerate_tpu_torch import (
    Accelerator,
    AcceleratedScheduler,
    ColumnDataset,
    Model,
    adamw,
    linear_schedule,
)
from accelerate_tpu_torch import native
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the driver runs several test processes at once,
    and torch's spinning thread pools would contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def port_state():
    PartialState(cpu=True)
    yield
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()


def _shards(mod, n, batch_size, procs, split=False, even=True, drop_last=False, seed=None):
    sampler = (mod.SequentialSampler(n) if seed is None
               else mod.SeedableRandomSampler(n, seed=seed))
    inner = mod.BatchSampler(sampler, batch_size=batch_size, drop_last=drop_last)
    return [list(mod.BatchSamplerShard(inner, num_processes=procs, process_index=i,
                                       split_batches=split, even_batches=even))
            for i in range(procs)]


@pytest.mark.parametrize("n,bs,procs,split,even,drop_last", [
    (24, 4, 2, False, True, False), (21, 4, 2, False, True, False),
    (21, 4, 2, False, False, False), (21, 4, 2, False, True, True),
    (22, 3, 4, False, True, False), (5, 4, 4, False, True, False),
    (16, 8, 2, True, True, False), (18, 8, 2, True, True, False),
    (18, 8, 2, True, False, False), (18, 8, 4, True, True, True),
])
def test_batch_sampler_shard_matches_jax(n, bs, procs, split, even, drop_last):
    port = _shards(tdl, n, bs, procs, split, even, drop_last)
    assert port == _shards(jdl, n, bs, procs, split, even, drop_last)
    for i in range(procs):
        lengths = [len(mod.BatchSamplerShard(mod.BatchSampler(mod.SequentialSampler(n), bs,
                                                              drop_last), procs, i, split, even))
                   for mod in (tdl, jdl)]
        assert lengths[0] == lengths[1]


def test_batch_sampler_shard_round_robin():
    b0, b1 = _shards(tdl, 24, 4, 2)
    assert len(b0) == len(b1) == 3
    assert b0[0] == [0, 1, 2, 3] and b1[0] == [4, 5, 6, 7]
    assert sorted(i for b in b0 + b1 for i in b) == list(range(24))


def test_batch_sampler_shard_uneven_even_batches():
    b0, b1 = _shards(tdl, 21, 4, 2)
    assert len(b0) == len(b1)
    assert all(len(b) == 4 for b in b0 + b1)


def test_batch_sampler_shard_split_batches():
    b0, b1 = _shards(tdl, 16, 8, 2, split=True)
    assert b0[0] == [0, 1, 2, 3] and b1[0] == [4, 5, 6, 7]
    assert len(b0) == len(b1) == 2


@pytest.mark.parametrize("n,bs,procs,split,drop_last", [
    (22, 4, 2, False, False), (22, 4, 2, False, True), (3, 4, 2, False, False),
    (22, 8, 2, True, False), (30, 2, 4, False, False)])
def test_iterable_dataset_shard_matches_jax(n, bs, procs, split, drop_last):
    def shards(mod):
        return [list(mod.IterableDatasetShard(list(range(n)), batch_size=bs,
                                              drop_last=drop_last, num_processes=procs,
                                              process_index=i, split_batches=split))
                for i in range(procs)]

    port = shards(tdl)
    assert port == shards(jdl)
    assert len({len(s) for s in port}) == 1
    if not split and n >= bs * procs:
        assert port[0][:bs] == list(range(bs)) and port[1][:bs] == list(range(bs, 2 * bs))


def test_seedable_random_sampler_across_epochs_and_after_load_state_dict():
    port, ref = tdl.SeedableRandomSampler(10, seed=5), jdl.SeedableRandomSampler(10, seed=5)
    epochs = [list(port) for _ in range(3)]
    assert epochs == [list(ref) for _ in range(3)]
    assert epochs[0] != epochs[1] and sorted(epochs[1]) == list(range(10))
    resumed = tdl.SeedableRandomSampler(10, seed=0)
    resumed.load_state_dict(ref.state_dict())  # the JAX sampler's state: epoch 3
    assert resumed.state_dict() == {"seed": 5, "epoch": 3}
    assert list(resumed) == list(ref)


class _ToyDataset:
    def __init__(self, n=32, dim=4):
        rng = np.random.default_rng(0)
        self.x = rng.normal(size=(n, dim)).astype(np.float32)
        self.y = (self.x.sum(-1) > 0).astype(np.int32)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return {"idx": np.int64(i), "x": self.x[i], "y": self.y[i]}


class RandomSampler:  # the name makes prepare_data_loader shuffle
    pass


class _LoaderSpec:
    def __init__(self, dataset, batch_size, shuffle=False, drop_last=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = RandomSampler() if shuffle else None
        self.drop_last = drop_last


def _indices(loader, epochs=1):
    out = []
    for epoch in range(epochs):
        loader.set_epoch(epoch)
        out += [np.asarray(b["idx"]).tolist() for b in loader]
    return out


@pytest.mark.parametrize("procs", [1, 2, 4])
@pytest.mark.parametrize("shuffle,drop_last,split", [
    (False, False, False), (True, False, False), (True, True, False), (True, False, True)])
def test_prepare_data_loader_shards_as_jax_does(procs, shuffle, drop_last, split):
    ds = _ToyDataset(n=37)
    for rank in range(procs):
        kw = dict(num_processes=procs, process_index=rank, put_on_device=False,
                  data_seed=11, split_batches=split)
        port = tdl.prepare_data_loader(_LoaderSpec(ds, 8, shuffle, drop_last), **kw)
        ref = jdl.prepare_data_loader(_LoaderSpec(ds, 8, shuffle, drop_last), **kw)
        assert _indices(port, 2) == _indices(ref, 2)
        assert len(port) == len(ref)
        assert port.total_batch_size == ref.total_batch_size


def test_end_of_dataloader_and_active_loader():
    dl = tdl.prepare_data_loader(_LoaderSpec(_ToyDataset(n=32), 8), put_on_device=False)
    gs = GradientState()
    flags = []
    assert not gs.in_dataloader
    for _ in dl:
        assert gs.active_dataloader is dl
        flags.append((dl.end_of_dataloader, gs.end_of_dataloader))
    assert flags == [(False, False)] * 3 + [(True, True)]
    assert not gs.in_dataloader and gs.remainder == -1


def test_drop_last_loader_sets_no_remainder():
    ds = _ToyDataset(n=90)
    dl = tdl.prepare_data_loader(_LoaderSpec(ds, 32, drop_last=True), put_on_device=False)
    remainders, sizes = [], []
    for b in dl:
        remainders.append(dl.remainder)
        sizes.append(len(b["x"]))
    assert sizes == [32, 32] and all(r <= 0 for r in remainders)
    dl2 = tdl.prepare_data_loader(_LoaderSpec(ds, 32), put_on_device=False)
    assert sum(len(b["x"]) for b in dl2) == 96 and dl2.remainder == 90 % 32


def test_gather_for_metrics_drops_the_repeated_tail():
    acc = Accelerator(cpu=True)
    dl = acc.prepare(_LoaderSpec(_ToyDataset(n=90), 32))
    seen = []
    for b in dl:
        seen += acc.gather_for_metrics(b["idx"]).tolist()
    assert seen == list(range(90))
    assert acc.reduce(torch.tensor(2.0), scale=0.5) == 1.0


@pytest.mark.parametrize("skip", [0, 2, 5])
def test_skip_first_batches(skip):
    ds = _ToyDataset(n=32)
    port = tdl.skip_first_batches(
        tdl.prepare_data_loader(_LoaderSpec(ds, 8, shuffle=True), put_on_device=False), skip)
    ref = jdl.skip_first_batches(
        jdl.prepare_data_loader(_LoaderSpec(ds, 8, shuffle=True), put_on_device=False), skip)
    got = [np.asarray(b["idx"]).tolist() for b in port]
    assert len(got) == max(0, 4 - skip) == len(port)
    assert got == [np.asarray(b["idx"]).tolist() for b in ref]
    plain = tdl.skip_first_batches([[1], [2], [3]], 1)
    assert list(plain) == [[2], [3]] and len(plain) == 2


def test_dispatcher_single_process():
    dl = tdl.prepare_data_loader(_LoaderSpec(_ToyDataset(n=16), 8), dispatch_batches=True,
                                 put_on_device=False)
    batches = list(dl)
    assert isinstance(dl, tdl.DataLoaderDispatcher) and len(dl) == 2
    assert [b["x"].shape for b in batches] == [(8, 4), (8, 4)]


@pytest.mark.parametrize("taken", [0, 2, 3, 4])
@pytest.mark.parametrize("resume_in", ["port", "jax"])
def test_mid_epoch_state_dict_round_trip(taken, resume_in):
    """Stop after `taken` batches of epoch 0, save the loader's state, resume
    it in a fresh loader of either package: the rest of epoch 0 and epoch 1
    are the batches of the uninterrupted run."""
    ds = _ToyDataset(n=32)

    def fresh(mod):
        return mod.prepare_data_loader(_LoaderSpec(ds, 8, shuffle=True), put_on_device=False,
                                       data_seed=3)

    full = _indices(fresh(tdl), 2)
    first = fresh(tdl)
    it = iter(first)
    seen = [np.asarray(next(it)["idx"]).tolist() for _ in range(taken)]
    state = first.state_dict()
    # The sampler's state at the start of the epoch being consumed.
    assert state == {"batches_yielded": taken, "sampler": {"seed": 3, "epoch": 0}}
    del it
    resumed = fresh(tdl if resume_in == "port" else jdl)
    resumed.load_state_dict(state)
    for _ in range(2):  # the rest of epoch 0 (none after 4), then epoch 1
        seen += [np.asarray(b["idx"]).tolist() for b in resumed]
    assert seen == full


def test_jax_loader_state_resumes_in_the_port():
    ds = _ToyDataset(n=32)
    ref = jdl.prepare_data_loader(_LoaderSpec(ds, 8, shuffle=True), put_on_device=False)
    it = iter(ref)
    head = [np.asarray(next(it)["idx"]).tolist() for _ in range(3)]
    port = tdl.prepare_data_loader(_LoaderSpec(ds, 8, shuffle=True), put_on_device=False)
    port.load_state_dict(ref.state_dict())
    rest = [np.asarray(b["idx"]).tolist() for b in port]
    assert head + rest == _indices(
        jdl.prepare_data_loader(_LoaderSpec(ds, 8, shuffle=True), put_on_device=False))


@pytest.mark.parametrize("prefetch", [0, 2])
def test_batches_are_tensors_on_the_asked_device(prefetch):
    ds = ColumnDataset(ids=np.arange(40, dtype=np.int32).reshape(20, 2),
                       w=np.linspace(0, 1, 20, dtype=np.float32))
    dl = tdl.prepare_data_loader(_LoaderSpec(ds, 4), device="cpu", prefetch_size=prefetch)
    batches = list(dl)
    assert len(batches) == 5 and not dl._pin
    for i, b in enumerate(batches):
        assert torch.is_tensor(b["ids"]) and b["ids"].device == torch.device("cpu")
        assert b["ids"].dtype == torch.int32 and b["w"].dtype == torch.float32
        np.testing.assert_array_equal(b["ids"].numpy(), ds.columns["ids"][4 * i: 4 * i + 4])
    cuda_loader = tdl.DataLoaderShard(ds, batch_sampler=dl.batch_sampler, device="cuda")
    assert cuda_loader._pin  # pinned host buffers and asynchronous copies on a card
    cuda_loader.non_blocking = False
    assert not cuda_loader._pin


def test_native_gathers_equal_numpy_and_honour_the_switch(monkeypatch):
    rng = np.random.default_rng(0)
    cols = {"a": rng.integers(0, 9, (50, 3)).astype(np.int32),
            "b": rng.normal(size=(50,)).astype(np.float32)}
    idx = rng.permutation(50)[:17]
    native.reset_paths()
    got = native.gather_columns(cols, idx, force=True)
    rows = native.gather_rows(cols["a"], idx, force=True)
    stacked = native.stack_items([cols["a"][i] for i in idx], force=True)
    for k in cols:
        np.testing.assert_array_equal(got[k], cols[k][idx])
    np.testing.assert_array_equal(rows, cols["a"][idx])
    np.testing.assert_array_equal(stacked, cols["a"][idx])
    assert native.get_lib() is not None, native.BUILD_ERROR
    assert {v["native"] for v in native.PATHS.values()} == {1}
    monkeypatch.setenv("ACCELERATE_DISABLE_NATIVE", "1")
    assert native.get_lib() is None
    np.testing.assert_array_equal(native.gather_rows(cols["a"], idx, force=True), rows)
    assert native.PATHS["gather_rows"] == {"native": 1, "plain": 1}


def test_prepare_returns_loaders_and_scheduler_in_order():
    """prepare(model, adamw(schedule), train, eval, schedule): the port's
    loaders, yielding the JAX package's indices, and its scheduler."""
    ds = _ToyDataset(n=24)
    schedule = linear_schedule(1e-3, 0.0, 10)
    acc = Accelerator(cpu=True)
    model, opt, train, evaluate, sched = acc.prepare(
        Model(torch.nn.Linear(4, 1)), adamw(schedule), _LoaderSpec(ds, 8, shuffle=True),
        _LoaderSpec(ds, 8), schedule)
    assert isinstance(train, tdl.DataLoaderShard) and isinstance(evaluate, tdl.DataLoaderShard)
    assert isinstance(sched, AcceleratedScheduler) and sched.optimizers == [opt]
    assert acc._dataloaders == [train, evaluate] and acc._schedulers == [sched]
    ref = jdl.prepare_data_loader(_LoaderSpec(ds, 8, shuffle=True), put_on_device=False)
    assert [b["idx"].tolist() for b in train] == _indices(ref)
    assert all(torch.is_tensor(b["x"]) for b in evaluate)
    for _ in range(3):
        sched.step()
    assert sched.get_last_lr() == pytest.approx(schedule(3))
