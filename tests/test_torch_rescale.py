"""The rescale layer's entries (primitives/rns.py rescale_words, rescale,
bgv_modswitch, and the kernel's entry ops/rescale_cuda.py drop_limbs on a CPU
tensor, its plain version) against the reference's rescale and ModSwitch,
exactly, and the rescale kernel's arithmetic (csrc/rescale.cu), replayed in
numpy from the kernel's own tables (ops/rescale_cuda.py make_drop_table),
against them. The kernel itself runs only on the card
(tests/test_torch_kernels_gpu.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpufhe_tpu.ops.context import make_context as ref_context
from gpufhe_tpu.params.params import preset as ref_preset
from gpufhe_tpu.primitives import rns as rrns
from gpufhe_tpu_torch.ops.context import make_context
from gpufhe_tpu_torch.ops import rescale_cuda
from gpufhe_tpu_torch.ops.rescale_cuda import make_drop_table
from gpufhe_tpu_torch.params.params import preset
from gpufhe_tpu_torch.primitives import rns as prns

# (preset, BGV ModSwitch?): the dw chain drops two limbs a rescale
PRESETS = [("tiny2", False), ("ci_small", False), ("boot_dw_ci", False), ("bgv_ci", True)]
LEADS = [(), (2,), (3, 2)]


@pytest.fixture(scope="module", params=PRESETS, ids=[p for p, _ in PRESETS])
def chain(request):
    name, bgv = request.param
    params, rparams = preset(name), ref_preset(name)
    return params, rparams, make_context(params, device="cpu"), ref_context(rparams), bgv


def _lift(v, q):
    return v - q if v > q // 2 else v


def tie_input(params, level, words, bgv, lead, seed):
    """Random canonical residues int64[*lead, level, N] whose first columns
    put each drop's lifted value at q_l // 2 and q_l // 2 + 1, the centred
    lift's tie: for BGV the value u = x [-t^-1]_{q_l} mod q_l, and for the
    second drop of a pair the value the first drop leaves."""
    qs, t = params.q_primes[:level], params.plain_modulus
    rng = np.random.default_rng(seed)
    q = np.asarray(qs, dtype=np.int64)[:, None]
    x = rng.integers(0, q, size=(*lead, level, params.n), dtype=np.int64)
    flat = x.reshape(-1, level, params.n)
    for d in range(words):
        q_l = qs[level - 1 - d]
        for col, want in ((2 * d, q_l // 2), (2 * d + 1, q_l // 2 + 1)):
            v = want * (-t) % q_l if bgv else want  # the residue whose value is `want`
            if d == 1:  # (CKKS) undo the first drop: v = v_b q_a + lift(x_a) mod q_b
                q_a, x_a = qs[level - 1], int(flat[0, level - 1, col])
                flat[:, level - 1, col] = x_a
                v = (v * q_a + _lift(x_a, q_a)) % q_l
            flat[:, level - 1 - d, col] = v
    return x


def kernel_model(x: np.ndarray, level: int, tables, bgv: bool) -> np.ndarray:
    """csrc/rescale.cu's 32-bit arithmetic in numpy, from its own tables:
    drop_value, drop_limb and mul_mod_shoup32, over every column at once."""
    tabs = [t.numpy().view(np.uint32).astype(np.uint64) for t in tables]
    words = len(tabs)

    def shoup(a, w, wp, q):  # modarith.cuh mul_mod_shoup32, a < 2^32
        assert (a < 2**32).all()
        r = (a * w - ((a * wp) >> np.uint64(32)) * q) & np.uint64(0xFFFFFFFF)
        return np.where(r >= q, r - q, r)

    def drop_value(tab, v):
        c = shoup(v, tab[1], tab[2], tab[0]) if bgv else v
        return c, c > tab[0] // np.uint64(2)

    def drop_limb(tab, i, v, c, lifts):
        rows = (len(tab) - 4) // 7
        q, qlmod, qlinv, qlinv_s, m, t, t_s = (tab[4 + r * rows + i] for r in range(7))
        qlmod = np.where(lifts, qlmod, np.uint64(0))
        a = v + shoup(c + m - qlmod, t, t_s, q) if bgv else v + m - c + qlmod
        return shoup(a, qlinv, qlinv_s, q)

    xs = x.reshape(-1, *x.shape[-2:]).astype(np.uint64)
    drops = []
    for d in range(words):
        v = xs[:, level - 1 - d]
        for e in range(d):
            v = drop_limb(tabs[e], level - 1 - d, v, *drops[e])
        drops.append(drop_value(tabs[d], v))
    out = np.empty((xs.shape[0], level - words, x.shape[-1]), dtype=np.int64)
    for i in range(level - words):
        v = xs[:, i]
        for d in range(words):
            v = drop_limb(tabs[d], i, v, *drops[d])
        out[:, i] = v
    return out.reshape(*x.shape[:-2], level - words, x.shape[-1])


@pytest.mark.parametrize("lead", LEADS, ids=["KN", "2KN", "32KN"])
@pytest.mark.parametrize("at", ["top", "edge"])
def test_drop_words_matches_reference_and_kernel_model(chain, lead, at):
    """Every leading shape, at the chain's top level and at K = words + 1:
    the entry == words sequential rescales (ModSwitch for BGV) == the
    reference's, slice for slice, drop_limbs on the CPU tensor with the
    cached tables == the entry, and the kernel's arithmetic == them."""
    params, rparams, ctx, rctx, bgv = chain
    words = 1 if bgv else params.scale_words
    level = params.num_limbs if at == "top" else words + 1
    x = tie_input(params, level, words, bgv, lead, seed=level + len(lead))
    xt = torch.from_numpy(x)
    if bgv:
        got = prns.bgv_modswitch(xt, params, level, ctx,
                                 prns.make_ks_context(params, level, device="cpu"))
    else:
        got = prns.rescale_words(xt, params, level, words, ctx)
        seq = xt
        for d in range(words):
            seq = prns.rescale(seq, params, level - d, ctx,
                               prns.make_ks_context(params, level - d, device="cpu"))
        assert torch.equal(got, seq)
    assert got.shape == (*lead, level - words, params.n)

    ref_fn = rrns.bgv_modswitch if bgv else rrns.rescale
    for idx in np.ndindex(*lead):
        want = jnp.asarray(x[idx].astype(np.uint32))
        for d in range(words):
            want = ref_fn(want, rparams, level - d, rctx, rrns.make_ks_context(rparams, level - d))
        assert (got[idx].numpy() == np.asarray(want).astype(np.int64)).all()

    tables = rescale_cuda.drop_tables(params.q_primes[:level], words, params.plain_modulus,
                                      torch.device("cpu"))
    assert tables is rescale_cuda.drop_tables(params.q_primes[:level], words,
                                              params.plain_modulus, torch.device("cpu"))
    assert torch.equal(rescale_cuda.drop_limbs(xt, level, tables, bgv), got)
    assert (kernel_model(x, level, tables, bgv) == got.numpy()).all()


def test_drop_table_layout():
    """make_drop_table's words: the header, then each row over the remaining
    limbs, m_i the least multiple of q_i at or above 2^30; the plain
    version reads them back as int64; a prime of 2^30 or more is refused."""
    params = preset("bgv_ci")
    qs, t = params.q_primes, params.plain_modulus
    tab = make_drop_table(qs, t, "cpu").numpy().view(np.uint32).astype(np.int64)
    q_l, rows = qs[-1], len(qs) - 1
    assert tab.shape == (4 + 7 * rows,)
    assert tab[0] == q_l and tab[1] == -pow(t, -1, q_l) % q_l
    assert tab[2] == (int(tab[1]) << 32) // q_l
    q, qlmod, qlinv, qlinv_s, m, t_mod, t_s = tab[4:].reshape(7, rows)
    assert (q == qs[:-1]).all() and (qlmod == q_l % q).all() and (qlinv * q_l % q == 1).all()
    assert (qlinv_s == (qlinv << 32) // q).all() and (t_s == (t_mod << 32) // q).all()
    assert (m % q == 0).all() and (m >= 2**30).all() and (m - q < 2**30).all()
    assert (t_mod == t % q).all()
    assert all(torch.equal(v.flatten(), torch.from_numpy(w)) for v, w in zip(
        rescale_cuda._table_rows(make_drop_table(qs, t, "cpu")).values(),
        (tab[0:1], tab[1:2], q, qlmod, qlinv, qlinv_s, m, t_mod, t_s)))
    with pytest.raises(ValueError):
        make_drop_table((5, 2**30 + 3), 0, "cpu")
