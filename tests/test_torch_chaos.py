"""The port's fault injector (accelerate_tpu_torch.chaos) against the JAX
package's (accelerate_tpu.chaos): the same ``(seed, rates, schedule)`` gives
the same ``injected`` log, bit for bit, over a grid of points, ticks, units
and seeds, with and without a schedule; ``deterministic_jitter`` and the
residual uniforms are equal; the validation refuses what the JAX injector
refuses. Both injectors are numpy-free pure Python: no tolerance."""

import itertools

import pytest

from accelerate_tpu import chaos as jchaos
from accelerate_tpu_torch import chaos

SEEDS = (0, 7, 12345)
TRAIN_RATES = {"train_step": {"nonfinite_grad": 0.05, "slow_step": 0.05, "bit_flip": 0.02},
               "checkpoint_save": 0.2, "dataloader_batch": {"corrupt_batch": 0.1},
               "collective_op": 0.1}
SERVE_RATES = {"prefill_dispatch": 0.1, "decode_tick": {"poison": 0.05, "bit_flip": 0.05},
               "draft_mismatch": 0.2}
SCHEDULE = [{"point": "train_step", "kind": "nonfinite_grad", "tick": 5},
            {"point": "train_step", "kind": "slow_step", "tick": 2, "seconds": 0.0},
            {"point": "checkpoint_save", "kind": "torn_write", "tick": 1, "unit": 0},
            {"point": "decode_tick", "kind": "bit_flip", "count": 2, "slot": 1},
            {"point": "host_heartbeat", "kind": "dead_host", "tick": 9, "exit_code": 71}]


def _draws(mod, seed, rates, schedule):
    inj = mod.FaultInjector(seed=seed, rates=rates, schedule=schedule)
    faults = []
    points = sorted(set(rates) | {e["point"] for e in schedule or []})
    for tick, point, unit in itertools.product(range(24), points, range(3)):
        f = inj.draw(point, tick, unit)
        faults.append(None if f is None else tuple(f))
    return inj.injected, faults, inj.summary()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("rates", [TRAIN_RATES, SERVE_RATES], ids=["train", "serve"])
@pytest.mark.parametrize("schedule", [None, SCHEDULE], ids=["rates", "schedule"])
def test_injected_logs_equal_the_jax_injectors(seed, rates, schedule):
    got = _draws(chaos, seed, rates, [dict(e) for e in schedule or []])
    want = _draws(jchaos, seed, rates, [dict(e) for e in schedule or []])
    assert got == want
    assert got[0]  # the grid draws faults


def test_deterministic_jitter_and_uniforms_equal_the_jax_ones():
    for seed, tick, attempt in itertools.product(SEEDS, range(6), range(4)):
        assert chaos.deterministic_jitter(seed, tick, attempt) == \
            jchaos.deterministic_jitter(seed, tick, attempt)
        assert chaos._u01(seed, "train_step", tick, attempt) == \
            jchaos._u01(seed, "train_step", tick, attempt)
    assert chaos.INJECTION_POINTS == jchaos.INJECTION_POINTS
    assert chaos.FAULT_KINDS == jchaos.FAULT_KINDS
    assert chaos._POINT_KINDS == jchaos._POINT_KINDS
    assert chaos.DEAD_HOST_DEFAULT_EXIT_CODE == jchaos.DEAD_HOST_DEFAULT_EXIT_CODE == 139


@pytest.mark.parametrize("kwargs", [
    dict(rates={"nowhere": 0.1}),
    dict(rates={"train_step": {"torn_write": 0.1}}),
    dict(rates={"train_step": {"nonfinite_grad": 1.5}}),
    dict(rates={"train_step": {"nonfinite_grad": 0.6, "slow_step": 0.6}}),
    dict(schedule=[{"point": "decode_tick", "kind": "dead_host"}]),
    dict(delay_ticks=0),
    dict(slow_step_s=-1.0),
])
def test_validation_refuses_what_the_jax_injector_refuses(kwargs):
    with pytest.raises(ValueError) as got:
        chaos.FaultInjector(**kwargs)
    with pytest.raises(ValueError) as want:
        jchaos.FaultInjector(**kwargs)
    assert str(got.value) == str(want.value)


def test_schedule_extras_and_on_inject():
    inj = chaos.FaultInjector(seed=1, schedule=[dict(SCHEDULE[1]), dict(SCHEDULE[4])])
    seen = []
    inj.on_inject = seen.append
    f = inj.draw("train_step", 2)
    assert f.kind == "slow_step" and f.extra == {"seconds": 0.0}
    assert inj.draw("train_step", 2) is None  # count 1: fired once
    f = inj.draw("host_heartbeat", 9, unit=3)
    assert f.extra == {"exit_code": 71} and f.unit == 3
    assert seen == inj.injected and inj.summary() == {
        "injected": 2, "by_site": {"host_heartbeat:dead_host": 1, "train_step:slow_step": 1}}
    err = chaos.InjectedFaultError(f)
    assert isinstance(err, RuntimeError) and err.fault is f
