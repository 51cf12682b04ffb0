"""A CPU model of kernel K1's 32-bit schedule (gpufhe_tpu_torch/csrc/ntt.cu).

The kernel runs only on the card. This file emulates, in numpy uint64
holding u32 words, what each of its threads computes: the register layout
(thread i loads t = T brev_P(r) + brev_T(i) into register r), the lazy
Harvey butterflies on stage-ordered roots with Shoup companions, the
exchange to positions i P + m, the Shoup twist, the Montgomery-form
twiddle applied with one REDC, and the canonical correction before each
store. Every intermediate the kernel keeps in a 32-bit word is checked to
stay below 2^32 (and within its lazy range). The model is held == the plain
version `fourstep_plain` (the oracle that tests/test_torch_ntt.py holds ==
the reference) at tiny, tiny2, ci_small and on config5_boot primes at
N = 2^16; the tables are checked against their definitions; the exchange
tile's addresses are checked to be a bijection and free of bank conflicts
for every warp access of the production layout, and the pairs of pass B's
t-fast side (two words per thread, one traded by a warp shuffle) are
checked to give each thread the inputs of the layout above and to write
every output word once.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gpufhe_tpu_torch.ops import ntt_cuda
from gpufhe_tpu_torch.ops.context import make_context, ntt_tables_np
from gpufhe_tpu_torch.params.params import preset

M32 = (1 << 32) - 1
BOOT_PRIMES = preset("config5_boot").q_primes[:3] + preset("config5_boot").p_primes[-2:]


def _brev(x, bits):
    return int(f"{x:0{bits}b}"[::-1], 2) if bits else 0


def _u32(x):
    x = np.asarray(x, dtype=np.uint64)
    assert (x <= M32).all(), "a value the kernel keeps in 32 bits overflowed"
    return x


# --- csrc/modarith.cuh, in 32-bit words -----------------------------------

def shoup_lazy(a, w, wp, q):
    """mul_shoup_lazy: a w - umulhi(a, w') q mod 2^32, in [0, 2q)."""
    a, w, wp, q = (np.asarray(v, dtype=np.uint64) for v in (a, w, wp, q))
    _u32(a)
    r = (((a * w) & M32) + (1 << 32) - ((((a * wp) >> 32) * q) & M32)) & M32  # mod 2^32
    assert (r < 2 * q).all()
    return r


def shoup(a, w, wp, q):
    """mul_mod_shoup32: the lazy product and one conditional subtract."""
    r = shoup_lazy(a, w, wp, q)
    return r - np.where(r >= q, q, 0).astype(np.uint64)


def mont_lazy(a, w, q, qinv_neg):
    """mont_mul_lazy: REDC(a w) for a w < q 2^32, in [0, 2q)."""
    a, w, q, qinv_neg = (np.asarray(v, dtype=np.uint64) for v in (a, w, q, qinv_neg))
    t = _u32(a) * _u32(w)
    assert (t < q << 32).all(), "REDC input bound a w < q 2^32"
    m = ((t & M32) * qinv_neg) & M32
    r = (t + m * q) >> 32
    assert (r < 2 * q).all()
    return r


def bfly(x, y, w, wp, q):
    """Harvey's lazy butterfly; w None is the root 1 (bfly1)."""
    q2 = 2 * q
    assert (_u32(x) < 2 * q2).all() and (_u32(y) < 2 * q2).all()
    a = np.where(x >= q2, x - q2, x)
    t = np.where(y >= q2, y - q2, y) if w is None else shoup_lazy(y, w, wp, q)
    return _u32(a + t), _u32(a - t + q2)  # a - t + q2 > 0: a >= 0, t < q2


# --- one pass of the kernel -----------------------------------------------

def k1_pass(a, q, qinv, tabs, pre=None, post=None):
    """R-point cyclic transforms along the last axis of a[rows, lanes, R]
    (natural order in and out), as the kernel's threads compute them.

    q, qinv: [rows, 1, 1] uint64; tabs: the pass's table rows per data row.
    pre/post(x, t_index_array) apply the twist on load and on store.
    """
    rows, lanes, r_len = a.shape
    logr = r_len.bit_length() - 1
    logt, logp = logr // 2, logr - logr // 2
    T, P = 1 << logt, 1 << logp
    i = np.arange(T)
    ib = np.array([_brev(k, logt) for k in i])
    roots, roots_p = tabs["roots"], tabs["roots_shoup"]  # [rows, 1, n1]

    def root(e):  # e: int array -> [rows, 1, len(e)], against [rows, lanes, ...]
        return roots[:, :, e], roots_p[:, :, e]

    # 1.-2. register r of thread (c, i) <- input t = T brev_P(r) + brev_T(i)
    v = [None] * P
    for u in range(P):
        t = u * T + ib  # [T]
        x = _u32(a[:, :, t])  # [rows, lanes, T]
        v[_brev(u, logp)] = pre(x, t[None, None, :]) if pre else x
    # 3. stages 0 .. logp-1 within the registers
    for s in range(logp):
        for r in range(P):
            if (r >> s) & 1:
                continue
            k = r & ((1 << s) - 1)
            w = (None, None) if k == 0 else root([(1 << s) + k])
            v[r], v[r + (1 << s)] = bfly(v[r], v[r + (1 << s)], w[0], w[1], q)
    # 4. the exchange: position i P + r; thread j takes m = j + T g, all i
    tile = np.stack(v, axis=-1)  # [rows, lanes, T (i), P (r)]
    m = np.arange(P)  # every m at once: the threads j and groups g together
    b = [tile[:, :, ii, :] for ii in range(T)]  # b[i]: [rows, lanes, P (m)]
    # 5. stages logp .. logr-1: butterfly k = m + P (i mod 2^s)
    for s in range(logt):
        for ii in range(T):
            if (ii >> s) & 1:
                continue
            e = (1 << (logp + s)) + m + P * (ii & ((1 << s) - 1))
            w, wp = root(e)
            b[ii], b[ii + (1 << s)] = bfly(b[ii], b[ii + (1 << s)], w, wp, q)
    # 6. twist on store, canonical, output k = i P + m
    out = np.empty_like(a)
    for ii in range(T):
        k = ii * P + m
        x = b[ii]
        x = post(x, k[None, None, :]) if post else np.where(x >= 2 * q, x - 2 * q, x)
        x = np.where(x >= q, x - q, x)
        assert (x < q).all()
        out[:, :, k] = x
    return out


def k1_model(x, chain, tabs, q, qinv, n1, n2, inverse):
    """Both passes, as ntt_fourstep launches them (u32 scratch between)."""
    rows, n = x.shape
    t = tabs["inv" if inverse else "fwd"]
    col = lambda k: t[k][chain][:, None, None, :]  # noqa: E731
    qq, qi = q[chain][:, None, None], qinv[chain][:, None, None]
    g = {k: t[k][chain][:, None, :] for k in ("roots", "roots_shoup")}
    lo, lop, him = col("lo"), col("lo_shoup"), col("hi_mont")
    t1d, t1dp = col("tab1d"), col("tab1d_shoup")

    def gather(tab, idx):  # tab [rows, 1, 1, len], idx [.., lanes, k] -> [rows, lanes, k]
        return np.take_along_axis(tab[:, 0], np.broadcast_to(idx, (rows, *idx.shape[1:])), axis=-1)

    def twiddle(k1, j2):  # psi^+-e 2^32 mod q, e = j2 (2 k1 + 1) mod 2N
        e = (j2 * (2 * k1 + 1)) % (2 * n)
        lo_i, hi_i = e % n1, e // n1
        return shoup(gather(him, hi_i), gather(lo, lo_i), gather(lop, lo_i), qq)

    j2 = np.arange(n2)[None, :, None]
    if not inverse:
        a = x.reshape(rows, n1, n2).transpose(0, 2, 1)  # [j2, j1]
        s = k1_pass(a, qq, qi, g,
                    pre=lambda v, t_: shoup_lazy(v, gather(t1d, t_), gather(t1dp, t_), qq),
                    post=lambda v, k_: mont_lazy(v, twiddle(k_, j2), qq, qi))
        scratch = _u32(s.transpose(0, 2, 1))  # [k1, j2]
        y = k1_pass(scratch, qq, qi, g)  # [k1, k2]
        return y.transpose(0, 2, 1).reshape(rows, n)
    b = k1_pass(x.reshape(rows, n2, n1).transpose(0, 2, 1), qq, qi, g)  # [k1, j2]
    scratch = _u32(b).transpose(0, 2, 1)  # [j2, k1]
    y = k1_pass(scratch, qq, qi, g,
                pre=lambda v, t_: mont_lazy(v, twiddle(t_, j2), qq, qi),
                post=lambda v, k_: shoup_lazy(v, gather(t1d, k_), gather(t1dp, k_), qq))
    return y.transpose(0, 2, 1).reshape(rows, n)


def _model_inputs(primes, psis, n):
    fwd, inv = ntt_tables_np(primes, psis, n)
    q = np.asarray(primes, dtype=np.uint64)
    qinv = np.asarray([(-pow(p, -1, 1 << 32)) % (1 << 32) for p in primes], dtype=np.uint64)
    tabs = {"fwd": {k: v.astype(np.uint64) for k, v in fwd.items()},
            "inv": {k: v.astype(np.uint64) for k, v in inv.items()}}
    return tabs, q, qinv


@pytest.mark.parametrize("name", ["tiny", "tiny2", "ci_small"])
@pytest.mark.parametrize("inverse", [False, True])
def test_model_equals_plain(name, inverse):
    params = preset(name)
    ctx = make_context(params, device="cpu")
    primes = ctx.primes
    tabs, q, qinv = _model_inputs(primes, params.psi, params.n)
    sel = list(range(len(primes)))[::-1]
    rng = np.random.default_rng(3)
    rows = sel * 2
    x = np.stack([rng.integers(0, primes[r], size=params.n) for r in rows])
    x[0] = primes[rows[0]] - 1  # the largest canonical residue everywhere
    got = k1_model(x.astype(np.uint64), np.asarray(rows), tabs, q, qinv, ctx.n1, ctx.n2, inverse)
    want = ntt_cuda.fourstep_plain(torch.from_numpy(x), ctx.index(sel, torch.int32), ctx, inverse)
    assert (got.astype(np.int64) == want.numpy()).all()


def test_model_at_n16_on_config5_boot_primes():
    """R = 256 both passes (16 threads x 16 registers), the path's primes."""
    params = preset("config5_boot")
    n = params.n
    ctx = make_context(params, device="cpu")
    rows = [0, 29, 44]  # first and last q-limb, last special prime
    primes = [ctx.primes[r] for r in rows]
    psis = [params.psi[r] for r in rows]
    tabs, q, qinv = _model_inputs(primes, psis, n)
    rng = np.random.default_rng(4)
    x = np.stack([rng.integers(0, p, size=n) for p in primes])
    x[1, : n // 2] = primes[1] - 1
    idx = ctx.index(rows, torch.int32)
    fwd = k1_model(x.astype(np.uint64), np.arange(3), tabs, q, qinv, ctx.n1, ctx.n2, False)
    assert (fwd.astype(np.int64) == ntt_cuda.fourstep_plain(torch.from_numpy(x), idx, ctx,
                                                             False).numpy()).all()
    back = k1_model(fwd, np.arange(3), tabs, q, qinv, ctx.n1, ctx.n2, True)
    assert (back.astype(np.int64) == x).all()


# --- the arithmetic at its worst cases ------------------------------------

WORST_Q = [(1 << 30) - 35, *BOOT_PRIMES, 1073479681, 97]


def _edge(q, rng, lim):
    return np.asarray([0, 1, q - 1, q, 2 * q - 1, 2 * q, lim - 1,
                       *rng.integers(0, lim, size=32)], dtype=np.uint64)


@pytest.mark.parametrize("q", WORST_Q)
def test_lazy_butterfly_at_worst_case_inputs(q):
    """x, y up to 4q - 1, q just under 2^30: outputs in [0, 4q), == x +- w y."""
    rng = np.random.default_rng(q)
    xs = _edge(q, rng, 4 * q)
    x, y = np.meshgrid(xs, xs)
    for w in (1, q - 1, int(rng.integers(1, q))):
        wp = (w << 32) // q
        s, d = bfly(x, y, np.uint64(w), np.uint64(wp), np.uint64(q))
        assert (s < 4 * q).all() and (d < 4 * q).all()
        xi, yi = x.astype(object), y.astype(object)
        assert ((s.astype(object) - xi - w * yi) % q == 0).all()
        assert ((d.astype(object) - xi + w * yi) % q == 0).all()
    s, d = bfly(x, y, None, None, np.uint64(q))
    assert ((s.astype(object) - x.astype(object) - y.astype(object)) % q == 0).all()
    assert (s < 4 * q).all() and (d < 4 * q).all()


@pytest.mark.parametrize("q", WORST_Q)
def test_twist_and_twiddle_products_at_worst_case_inputs(q):
    """Shoup on v < 4q, the Montgomery twiddle on v < 4q: ranges and values."""
    rng = np.random.default_rng(q + 1)
    qinv = (-pow(q, -1, 1 << 32)) % (1 << 32)
    v = _edge(q, rng, 4 * q)
    for lo, hi in ((q - 1, q - 1), (1, 1), (int(rng.integers(0, q)), int(rng.integers(0, q)))):
        lop, him = (lo << 32) // q, (hi << 32) % q
        tw = shoup(np.uint64(him), np.uint64(lo), np.uint64(lop), np.uint64(q))
        assert int(tw) == lo * hi * (1 << 32) % q
        got = mont_lazy(v, np.broadcast_to(tw, v.shape), np.uint64(q), np.uint64(qinv))
        assert (got < 2 * q).all()
        assert all(int(g) % q == int(a) * lo * hi % q for g, a in zip(got, v))
        t = shoup_lazy(v, np.uint64(lo), np.uint64(lop), np.uint64(q))
        assert all(int(g) % q == int(a) * lo % q for g, a in zip(t, v))


def test_tables_against_their_definitions():
    params = preset("ci_small")
    ctx = make_context(params, device="cpu")
    q = np.asarray(ctx.primes, dtype=object)[:, None]
    u32 = lambda t: t.numpy().view(np.uint32).astype(object)  # noqa: E731
    n, n1 = params.n, ctx.n1
    for t, sign in ((ctx.ntt_fwd, 1), (ctx.ntt_inv, -1)):
        k = t.k1
        assert all(getattr(k, f.name).dtype == torch.int32 for f in dataclasses.fields(k))
        assert (u32(k.q) == q[:, 0]).all()
        assert (u32(k.qinv_neg) * q[:, 0] % (1 << 32) == (1 << 32) - 1).all()
        assert (u32(k.tab1d) == t.tab1d.numpy()).all() and (u32(k.lo) == t.lo.numpy()).all()
        for v, vp in ((k.roots, k.roots_shoup), (k.tab1d, k.tab1d_shoup), (k.lo, k.lo_shoup)):
            assert (u32(vp) == u32(v) * (1 << 32) // q).all()
        assert (u32(k.hi_mont) == t.hi.numpy().astype(object) * (1 << 32) % q).all()
        roots = u32(k.roots)
        w = t.w.numpy().astype(object)  # w^e for e < N/2
        for s in range(n1.bit_length() - 1):
            for k in range(1 << s):
                assert (roots[:, (1 << s) + k] == w[:, k * n >> (s + 1)]).all()
        assert (roots[:, 0] == 1).all()
        # the roots of the inverse are the forward's inverses
        if sign < 0:
            fr = u32(ctx.ntt_fwd.k1.roots)
            assert ((fr * roots) % q == 1).all()


# --- the exchange tile ----------------------------------------------------

def _geometry(logr, padded=True):
    logt, logp = logr // 2, logr - logr // 2
    T, P = 1 << logt, 1 << logp
    row = P + 1 if padded else P
    col = T * row + 1 if padded else (1 << logr)
    return T, P, row, col


def _pair_class(s, logt):
    """csrc/ntt.cu pair_class: the class of t mod T that thread s of a group takes."""
    h = 1 << (logt - 1)
    return 2 * (s & (h - 1)) + (s >= h)


def _split(tid, lanes, logt, index_fast, padded=True, out=False, pairs=True):
    """csrc/ntt.cu split: (column, index) of thread tid."""
    log_lanes = lanes.bit_length() - 1
    if not index_fast:
        return tid & (lanes - 1), tid >> log_lanes
    i, g = tid & ((1 << logt) - 1), tid >> logt
    if pairs:
        i = _pair_class(i, logt) if out else _brev(_pair_class(i, logt), logt)
    if not padded:
        return g, i
    log_per = log_lanes - logt
    return ((g & ((1 << log_per) - 1)) << logt) + (g >> log_per), i


def _warps(logr, lanes, index_fast, write, padded=True, pairs=True):
    """Word addresses of each warp's accesses: per warp, per register."""
    T, P, row, col = _geometry(logr, padded)
    logt = logr // 2
    nthr = lanes * T
    out = []
    for w0 in range(0, nthr, 32):
        threads = [_split(t, lanes, logt, index_fast, padded, out=not write, pairs=pairs)
                   for t in range(w0, min(w0 + 32, nthr))]
        if write:  # thread (c, i) writes registers r at c COL + i ROW + r
            regs = [[c * col + i * row + r for c, i in threads] for r in range(P)]
        else:  # thread (c, j) reads i ROW + j + T g
            regs = [[c * col + i * row + j + T * g for c, j in threads]
                    for g in range(P // T) for i in range(T)]
        out.append(regs)
    return out


@pytest.mark.parametrize("logr", range(3, 9))
def test_exchange_is_a_bijection(logr):
    lanes = 32
    T, P, _, _ = _geometry(logr)
    for in_fast in (False, True):
        for out_fast in (False, True):
            wrote = sorted(a for w in _warps(logr, lanes, in_fast, True) for reg in w for a in reg)
            read = sorted(a for w in _warps(logr, lanes, out_fast, False) for reg in w for a in reg)
            assert wrote == read and len(set(wrote)) == lanes * T * P
    for fast in (False, True):  # each side's thread map is a bijection
        for out in (False, True):
            assert len({_split(t, lanes, logr // 2, fast, out=out)
                        for t in range(lanes * T)}) == lanes * T


@pytest.mark.parametrize("logr", range(3, 9))
def test_ntt_pass_block_exchanges_are_bijections(logr):
    """ntt_pass's blocks: pass A on a block narrower than a t-fast group
    (lanes < T: both sides lane-fast, 2 columns at boot_dw_ci), and pass B
    on a block of rows with both sides t-fast, the int64 side unpaired (one
    word per thread) and the u32 side paired: every word of the tile is
    written once and read once."""
    T, P, _, _ = _geometry(logr)
    for lanes in (1, 2, 4):  # pass A, lane-fast both sides
        wrote = sorted(a for w in _warps(logr, lanes, False, True) for reg in w for a in reg)
        read = sorted(a for w in _warps(logr, lanes, False, False) for reg in w for a in reg)
        assert wrote == read and len(set(wrote)) == lanes * T * P
    for lanes in (T, 32):  # pass B rows: in unpaired (int64) -> out paired, and back
        if lanes < T:
            continue
        for in_pairs, out_pairs in ((False, True), (True, False)):
            wrote = sorted(a for w in _warps(logr, lanes, True, True, pairs=in_pairs)
                           for reg in w for a in reg)
            read = sorted(a for w in _warps(logr, lanes, True, False, pairs=out_pairs)
                          for reg in w for a in reg)
            assert wrote == read and len(set(wrote)) == lanes * T * P
        for out in (False, True):
            assert len({_split(t, lanes, logr // 2, True, out=out, pairs=False)
                        for t in range(lanes * T)}) == lanes * T


@pytest.mark.parametrize("logr", range(3, 9))
def test_tfast_pairs_load_and_store_the_layout(logr):
    """Pass B's t-fast side, one column: thread s loads words 2 T w + 2 s, +1
    (a uint2: the group's 2T words, 8T bytes, 128 at R = 256) and trades one
    with thread s ^ T/2; it then holds t = u T + m in register brev_P(u),
    m = pair_class(s), as the kernel's layout needs. On the way out, thread
    s of class m holds outputs k = d T + m in register (d mod P/T) T +
    d div (P/T); after the trade every word of the row is written once, with
    its own value."""
    logt, logp = logr // 2, logr - logr // 2
    T, P = 1 << logt, 1 << logp
    h, PT = T // 2, P // T
    row = np.arange(1 << logr) + 1000  # word t holds 1000 + t

    def high(s):
        return s >= h

    if logr == 8:
        assert 8 * T == 128  # bytes per uint2 access of a group
    loaded = {s: [row[2 * T * w + 2 * s: 2 * T * w + 2 * s + 2] for w in range(P // 2)]
              for s in range(T)}
    for s in range(T):
        m, partner = _pair_class(s, logt), s ^ h
        assert _pair_class(partner, logt) == m ^ 1
        v = [None] * P
        for w in range(P // 2):
            a, b = loaded[s][w], loaded[partner][w]
            got = b[0] if high(partner) else b[1]  # what the partner sends
            v[_brev(2 * w, logp)] = got if high(s) else a[0]
            v[_brev(2 * w + 1, logp)] = a[1] if high(s) else got
        assert v == [row[_brev(r, logp) * T + m] for r in range(P)]
    regs = {s: [None] * P for s in range(T)}  # outputs k = d T + class, value k
    for s in range(T):
        for d in range(P):
            regs[s][(d % PT) * T + d // PT] = d * T + _pair_class(s, logt)
    written = {}
    for s in range(T):
        partner = s ^ h
        for w in range(P // 2):
            even = regs[s][((2 * w) % PT) * T + (2 * w) // PT]
            odd = regs[s][((2 * w + 1) % PT) * T + (2 * w + 1) // PT]
            pe = regs[partner][((2 * w) % PT) * T + (2 * w) // PT]
            po = regs[partner][((2 * w + 1) % PT) * T + (2 * w + 1) // PT]
            got = pe if high(partner) else po
            pair = (got, odd) if high(s) else (even, got)
            for j, val in enumerate(pair):
                word = 2 * T * w + 2 * s + j
                assert word not in written
                written[word] = val
    assert written == {k: k for k in range(1 << logr)}


@pytest.mark.parametrize("logr", range(3, 9))
def test_exchange_has_no_bank_conflicts(logr):
    """Every warp access of the padded tile hits 32 distinct banks, on both
    sides, lane-fast and index-fast; the unpadded tile (the natural_store
    ablation) does not."""
    for index_fast in (False, True):
        for write in (False, True):
            for regs in _warps(logr, 32, index_fast, write):
                for addrs in regs:
                    assert len({a % 32 for a in addrs}) == len(addrs) == 32
    worst = max(max(np.bincount([a % 32 for a in addrs]).max() for addrs in regs)
                for regs in _warps(logr, 32, False, True, padded=False))
    assert worst == min(1 << logr, 32)  # the lane-fast write: column stride R


def test_wrapper_refuses_lengths_and_primes_it_has_no_build_for():
    import dataclasses

    ctx = make_context(preset("tiny2"), device="cpu")
    x = torch.zeros((1, ctx.n), dtype=torch.int64)
    idx = ctx.index([0], torch.int32)
    before = ntt_cuda.KERNEL.launches
    with pytest.raises(ValueError, match="below 2"):
        ntt_cuda.fourstep_cuda(x, idx, dataclasses.replace(ctx, primes=(*ctx.primes, 1 << 30)),
                               False)
    with pytest.raises(ValueError, match="no K1 build"):
        ntt_cuda.fourstep_cuda(x, idx, dataclasses.replace(ctx, n1=512, n2=ctx.n // 512), False)
    assert ntt_cuda.KERNEL.launches == before
