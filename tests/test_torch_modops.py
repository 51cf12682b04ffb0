"""gpufhe_tpu_torch.ops.modops (int64 torch) vs gpufhe_tpu.ops.modops (uint32 jnp)
and the golden Montgomery model: the same inputs give the same values, exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpufhe_tpu.golden import arithmetic as ga
from gpufhe_tpu.ops import modops as ref
from gpufhe_tpu_torch.ops import modops as port

SIZE = 1024
PRIMES = [(1 << 30) - 35, 1073479681, (1 << 28) + 625, 786433]


def _u32(x):
    return jnp.asarray(np.asarray(x, dtype=np.uint32))


def _t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.int64))


def _np(x):
    return np.asarray(x).astype(np.int64)


@pytest.fixture(params=PRIMES)
def q(request):
    return request.param


def test_add_sub_neg(q):
    rng = np.random.default_rng(q)
    a = rng.integers(0, q, size=SIZE, dtype=np.int64)
    b = rng.integers(0, q, size=SIZE, dtype=np.int64)
    a[:3], b[:3] = [0, q - 1, 0], [0, q - 1, q - 1]
    qj = jnp.uint32(q)
    assert (port.add_mod(_t(a), _t(b), q).numpy() == _np(ref.add_mod(_u32(a), _u32(b), qj))).all()
    assert (port.sub_mod(_t(a), _t(b), q).numpy() == _np(ref.sub_mod(_u32(a), _u32(b), qj))).all()
    assert (port.neg_mod(_t(a), q).numpy() == _np(ref.neg_mod(_u32(a), qj))).all()


def test_mont_mul_and_forms(q):
    """Any a < 2^32 against canonical b, as the reference admits."""
    rng = np.random.default_rng(q + 1)
    qinv, r2 = ga.mont_constants(q)
    a = rng.integers(0, 1 << 32, size=SIZE, dtype=np.int64)
    a[:2] = [0, (1 << 32) - 1]
    b = rng.integers(0, q, size=SIZE, dtype=np.int64)
    got = port.mont_mul(_t(a), _t(b), q, qinv).numpy()
    assert (got == ga.mont_mul(a, b, q, qinv)).all()
    assert (got == _np(ref.mont_mul(_u32(a), _u32(b), jnp.uint32(q), jnp.uint32(qinv)))).all()
    c = rng.integers(0, q, size=SIZE, dtype=np.int64)
    m = port.to_mont(_t(c), q, qinv, r2)
    assert (m.numpy() == ga.to_mont(c, q)).all()
    assert (port.from_mont(m, q, qinv).numpy() == c).all()
    assert (port.mul_mod(_t(c), _t(b), q).numpy() == ga.vec_mul(c, b, q)).all()


@pytest.mark.parametrize("terms", [1, 2, 3, 6])
def test_mont_mac_matches_reference(q, terms):
    rng = np.random.default_rng(q + terms)
    qinv, _ = ga.mont_constants(q)
    a = [rng.integers(0, 1 << 32, size=SIZE, dtype=np.int64) for _ in range(terms)]
    b = [rng.integers(0, q, size=SIZE, dtype=np.int64) for _ in range(terms)]
    want = ref.mont_mac([(_u32(x), _u32(y)) for x, y in zip(a, b)], jnp.uint32(q), jnp.uint32(qinv))
    got = port.mont_mac([(_t(x), _t(y)) for x, y in zip(a, b)], q, qinv)
    assert (got.numpy() == _np(want)).all()


def test_shoup_and_barrett(q):
    rng = np.random.default_rng(q + 7)
    a = rng.integers(0, 1 << 32, size=SIZE, dtype=np.int64)
    a[:2] = [0, (1 << 32) - 1]
    w = rng.integers(0, q, size=SIZE, dtype=np.int64)
    wsh = port.shoup_np(w, q)
    assert (wsh == ref.shoup_np(w, q).astype(np.int64)).all()
    got = port.shoup_mul(_t(a), _t(w), _t(wsh), q).numpy()
    want = _np(ref.shoup_mul(_u32(a), _u32(w), _u32(wsh), jnp.uint32(q)))
    assert (got == want).all() and (got < 2 * q).all()
    assert (port.barrett_reduce_u32(_t(a), q).numpy() == _np(ref.barrett_reduce_u32(_u32(a), jnp.uint32(q)))).all()


def test_mulhi32_exact():
    rng = np.random.default_rng(3)
    a = rng.integers(0, 1 << 32, size=SIZE, dtype=np.int64)
    b = rng.integers(0, 1 << 32, size=SIZE, dtype=np.int64)
    a[:2], b[:2] = (1 << 32) - 1, (1 << 32) - 1
    want = (a.astype(object) * b.astype(object)) >> 32
    assert (port.mulhi32(_t(a), _t(b)).numpy().astype(object) == want).all()
