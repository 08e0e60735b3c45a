"""The port's lock-order witness (``transmogrifai_tpu_torch/utils/locks.py``)
beside the JAX package's: the seven cases of ``tests/test_lock_witness.py``
against the port's copy, and the violation text of one inversion equal in
both packages (the same call sites, so the same message). The locks are
taken in ``tests/_torch_witness_sites.py``: the witness leaves frames of
files named ``*locks.py`` out of the sites it reports."""
import pytest

from transmogrifai_tpu.utils import locks as jlocks
from transmogrifai_tpu_torch.utils import locks

from _torch_witness_sites import nest as _nest
from _torch_witness_sites import run as _run


@pytest.fixture(autouse=True)
def _disarmed():
    """Every test starts and ends with both witnesses disarmed and
    empty."""
    for m in (locks, jlocks):
        m.disarm()
        m.reset()
    yield
    for m in (locks, jlocks):
        m.disarm()
        m.reset()


def test_intentional_inversion_raises_with_both_stacks():
    a = locks.witness_lock("wA")
    b = locks.witness_lock("wB")
    locks.arm(raise_on_violation=True)
    _run(lambda: _nest(a, b))
    with pytest.raises(locks.LockOrderViolation) as ei:
        _nest(b, a)
    msg = str(ei.value)
    assert "'wA'" in msg and "'wB'" in msg
    assert msg.count("_torch_witness_sites.py") >= 2
    assert "witness-helper" in msg
    assert not a.locked() and not b.locked()
    assert len(locks.violations()) == 1


def test_record_mode_collects_without_raising():
    a = locks.witness_lock("rA")
    b = locks.witness_lock("rB")
    locks.arm(raise_on_violation=False)
    _run(lambda: _nest(a, b))
    _nest(b, a)
    v = locks.violations()
    assert len(v) == 1 and "'rA'" in v[0] and "'rB'" in v[0]


def test_consistent_order_and_reentrancy_are_clean():
    a = locks.witness_lock("cA")
    r = locks.witness_lock("cR", reentrant=True)
    locks.arm(raise_on_violation=True)
    for _ in range(3):
        with a:
            with r:
                with r:
                    pass
    _run(lambda: _nest(a, r))
    assert locks.violations() == []


def test_flock_brackets_join_the_order_graph():
    a = locks.witness_lock("fA")
    locks.arm(raise_on_violation=True)

    def flock_then_lock():
        locks.witness_acquire("flock.pointer")
        try:
            with a:
                pass
        finally:
            locks.witness_release("flock.pointer")

    _run(flock_then_lock)
    with pytest.raises(locks.LockOrderViolation):
        with a:
            locks.witness_acquire("flock.pointer")
    locks.witness_release("flock.pointer")
    assert len(locks.violations()) == 1


def test_disarmed_witness_costs_nothing_and_records_nothing():
    a = locks.witness_lock("dA")
    b = locks.witness_lock("dB")
    _run(lambda: _nest(a, b))
    _nest(b, a)
    assert locks.violations() == []


def test_armed_context_manager_restores_state():
    assert not locks.is_armed()
    with locks.armed(raise_on_violation=True):
        assert locks.is_armed()
    assert not locks.is_armed()


def test_witnessed_lock_api_shape():
    a = locks.witness_lock("sA")
    assert a.acquire() is True
    assert a.locked()
    got = []
    _run(lambda: got.append(a.acquire(blocking=False)))
    assert got == [False]
    a.release()
    assert not a.locked()
    assert "sA" in repr(a)


def _inversion(mod):
    """One AB/BA inversion through ``mod`` in record mode, from the same
    call sites whichever package ``mod`` is; returns the violations."""
    a = mod.witness_lock("pA")
    b = mod.witness_lock("pB")
    mod.arm(raise_on_violation=False)
    _run(lambda: _nest(a, b))
    _nest(b, a)
    out = mod.violations()
    mod.disarm()
    return out


def test_violation_text_equals_the_jax_packages():
    """The same inversion records the same message, word for word, in
    both packages, and the public names are the same."""
    mine, theirs = _inversion(locks), _inversion(jlocks)
    assert len(mine) == 1 and mine == theirs
    assert mine[0].startswith("lock-order inversion: thread 'MainThread' "
                              "holds 'pB'")
    assert locks.__all__ == jlocks.__all__
