"""The port's batched multiply against B single multiplies and the reference.

ciphertext/batch.py: stack / unstack round-trip a list of ciphertexts;
ct_mul_batched of B pairs == ct_mul_full of each pair limb for limb (the
port has no vmap: the pairs go through the kernels one after another), and
== the reference's ct_mul_batched (its jax.vmap of tensor, relinearisation
and one rescale) on the same keys and ciphertexts, carried into the port
with interop.batch_from_numpy; the products decode within 1e-2
(tests/test_pipeline.py:109). At a double-word preset the reference's
batched core rescales once, and so does the port's.
"""

import numpy as np
import pytest
import torch

from gpufhe_tpu.ciphertext import batch as rbatch
from gpufhe_tpu.ciphertext import ct as rct
from gpufhe_tpu.keys import keys as rkeys
from gpufhe_tpu.ops.context import make_context as ref_context
from gpufhe_tpu.params.params import preset as ref_preset
from gpufhe_tpu_torch import interop
from gpufhe_tpu_torch.ciphertext import batch
from gpufhe_tpu_torch.ciphertext import ct as pct
from gpufhe_tpu_torch.encoding import encoder as penc
from gpufhe_tpu_torch.ops.context import make_context
from gpufhe_tpu_torch.params.params import preset


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's PyTorch CPU work: its tensors are
    small (N <= 2^10), and tier-1 runs several worker processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


B = 3


@pytest.fixture(scope="module")
def tiny2():
    params, rparams = preset("tiny2"), ref_preset("tiny2")
    rchest = rkeys.keygen(rparams, np.random.default_rng(0))
    chest = interop.chest_from_reference(rchest, "cpu")
    ctx = make_context(params, device="cpu")
    rng = np.random.default_rng(1)
    zs = [rng.uniform(-1, 1, size=(2, params.slots)) for _ in range(B)]
    cts = [[pct.encrypt(penc.encode(z[k] + 0j, params), params, chest.device_pk, ctx,
                        np.random.default_rng(10 + 2 * i + k), params.scale) for k in range(2)]
           for i, z in enumerate(zs)]
    return params, rparams, rchest, chest, ctx, zs, cts


def test_stack_unstack_round_trip(tiny2):
    *_, cts = tiny2
    firsts = [pair[0] for pair in cts]
    sb = batch.stack(firsts)
    assert sb.batch == B and tuple(sb.c[0].shape) == (B, *firsts[0].c[0].shape)
    for got, want in zip(batch.unstack(sb), firsts):
        assert (got.level, got.scale) == (want.level, want.scale)
        for g, w in zip(got.c, want.c):
            assert (g == w).all()


def test_batched_multiply_equals_single_multiplies(tiny2):
    params, rparams, rchest, chest, ctx, zs, cts = tiny2
    a = batch.stack([pair[0] for pair in cts])
    b = batch.stack([pair[1] for pair in cts])
    out = batch.ct_mul_batched(a, b, params, ctx, chest.device_rlk)
    assert out.batch == B
    for i, (got, (x, y)) in enumerate(zip(batch.unstack(out), cts)):
        want = pct.ct_mul_full(x, y, params, ctx, chest.device_rlk)
        assert (got.level, got.scale) == (want.level, want.scale)
        for g, w in zip(got.c, want.c):
            assert (g == w).all()
        dec = pct.decrypt_decode(got, params, chest.device_sk, ctx)
        assert np.abs(dec - zs[i][0] * zs[i][1]).max() < 1e-2  # tests/test_pipeline.py:109


def test_batched_multiply_matches_reference(tiny2):
    """The reference's vmapped batch on the same ciphertexts (its jnp path on
    the CPU), carried back as numpy: == the port's limb for limb."""
    import jax.numpy as jnp

    params, rparams, rchest, chest, ctx, zs, cts = tiny2
    ra, rb = (rbatch.CiphertextBatch(
        [jnp.asarray(np.stack([pair[k].c[i].numpy() for pair in cts]).astype(np.uint32))
         for i in range(2)], params.num_limbs, params.scale) for k in range(2))
    rout = rbatch.ct_mul_batched(ra, rb, rparams, ref_context(rparams), rchest.device_rlk)
    carried = interop.batch_from_numpy([np.asarray(c) for c in rout.c], rout.level,
                                       rout.scale, "cpu")
    a, b = (batch.stack([pair[k] for pair in cts]) for k in range(2))
    out = batch.ct_mul_batched(a, b, params, ctx, chest.device_rlk)
    assert (out.level, out.scale) == (carried.level, carried.scale)
    for g, w in zip(out.c, carried.c):
        assert (g == w).all()
    for got, want in zip(batch.unstack(out), rbatch.unstack(rout)):
        assert isinstance(want, rct.Ciphertext)
        assert (got.c[0].numpy() == np.asarray(want.c[0]).astype(np.int64)).all()


def test_double_word_batch_rescales_once_as_the_reference():
    """At a double-word preset (boot_dw_ci) the reference's batched core
    rescales once, not scale_words times; the port's batch does the same
    (ct_mul per pair) and == the reference's limb for limb."""
    import jax.numpy as jnp

    params, rparams = preset("boot_dw_ci"), ref_preset("boot_dw_ci")
    rchest = rkeys.keygen(rparams, np.random.default_rng(3))
    chest = interop.chest_from_reference(rchest, "cpu")
    ctx = make_context(params, device="cpu")
    rng = np.random.default_rng(4)
    pairs = [[pct.encrypt(penc.encode(rng.uniform(-1, 1, size=params.slots) + 0j, params),
                          params, chest.device_pk, ctx, np.random.default_rng(20 + 2 * i + k),
                          params.scale) for k in range(2)] for i in range(2)]
    a, b = (batch.stack([p[k] for p in pairs]) for k in range(2))
    out = batch.ct_mul_batched(a, b, params, ctx, chest.device_rlk)
    ra, rb = (rbatch.CiphertextBatch([jnp.asarray(c.numpy().astype(np.uint32)) for c in x.c],
                                     x.level, x.scale) for x in (a, b))
    rout = rbatch.ct_mul_batched(ra, rb, rparams, ref_context(rparams), rchest.device_rlk)
    assert out.level == rout.level == params.num_limbs - 1
    assert out.scale == rout.scale
    for g, w in zip(out.c, rout.c):
        assert (g.numpy() == np.asarray(w).astype(np.int64)).all()
