"""The port's encrypted models against the reference's.

Each model of gpufhe_tpu_torch/models on the port's DeviceBackend (on the
CPU; BGVDeviceBackend / BFVDeviceBackend for PIR) against the same model of
gpufhe_tpu/models on the reference's GoldenBackend (BGVGoldenBackend /
BFVGoldenBackend), which is limb-equal to its device backends, with the same
keys (carried by interop.chest_from_reference), the same numpy-seeded
weights and inputs, and the presets of the reference's own tests. Outputs are
== limb for limb at an equal level, scales within 1e-12 relative; each decode
is held to the tolerance of the reference test it mirrors (file:line beside
it); PIR's records are exact. The MLP's plans, built from each layer's block,
are == the dense route's (a slots x slots embedding), handle for handle. The
port's square networks without a refresh (the MLP, the CNN over it), entered
with a limb to spare, carry their activations `lift` times larger
(models/mlp.py _lift_of): they are held == the reference's EncryptedMLP
given the port's lift (tests/lifted_mlp.py `LiftedMLP`), and == the
reference's own where the lift is 1.
"""

import numpy as np
import pytest
import torch

from gpufhe_tpu.ciphertext import bfv as rbfv
from gpufhe_tpu.ciphertext import bfv_backend as rbfvb
from gpufhe_tpu.ciphertext import bgv as rbgv
from gpufhe_tpu.ciphertext import bgv_backend as rbgvb
from gpufhe_tpu.ciphertext.backend import GoldenBackend
from gpufhe_tpu.ciphertext.bootstrap import Bootstrapper as RefBootstrapper
from gpufhe_tpu.ciphertext.bootstrap import bootstrap_rotations
from gpufhe_tpu.golden import bfv as rgbfv
from gpufhe_tpu.golden import bgv as rgbgv
from gpufhe_tpu.golden import ckks as rgckks
from gpufhe_tpu.keys import keys as rkeys
from gpufhe_tpu.models import attention as ratt
from gpufhe_tpu.models import cnn as rcnn
from gpufhe_tpu.models import linear as rlinear
from gpufhe_tpu.models import logreg as rlogreg
from gpufhe_tpu.models import logreg_train as rtrain
from gpufhe_tpu.models import mlp as rmlp
from gpufhe_tpu.models import pir as rpir
from gpufhe_tpu.models import transformer as rxf
from gpufhe_tpu.params.params import preset as ref_preset
from gpufhe_tpu_torch import interop
from gpufhe_tpu_torch import models as pmodels
from gpufhe_tpu_torch.ciphertext import bfv as pbfv
from gpufhe_tpu_torch.ciphertext import bfv_backend as pbfvb
from gpufhe_tpu_torch.ciphertext import bgv as pbgv
from gpufhe_tpu_torch.ciphertext import bgv_backend as pbgvb
from gpufhe_tpu_torch.ciphertext import ct as pct
from gpufhe_tpu_torch.ciphertext.backend import DeviceBackend
from gpufhe_tpu_torch.ciphertext.bootstrap import Bootstrapper
from gpufhe_tpu_torch.ciphertext.linalg import BsgsPlan
from gpufhe_tpu_torch.encoding import encoder as penc
from gpufhe_tpu_torch.models import attention as patt
from gpufhe_tpu_torch.models import cnn as pcnn
from gpufhe_tpu_torch.models import linear as plinear
from gpufhe_tpu_torch.models import logreg as plogreg
from gpufhe_tpu_torch.models import logreg_train as ptrain
from gpufhe_tpu_torch.models import mlp as pmlp
from gpufhe_tpu_torch.models import pir as ppir
from gpufhe_tpu_torch.models import transformer as pxf
from gpufhe_tpu_torch.ops.context import make_context
from gpufhe_tpu_torch.params.params import preset
from lifted_mlp import LiftedMLP


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's PyTorch CPU work: its tensors are
    small (N <= 2^10), and tier-1 runs several worker processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class Pair:
    """The port's DeviceBackend on the CPU and the reference's GoldenBackend
    on one reference key chest (keys.keygen from default_rng(seed))."""

    def __init__(self, name, rotations=(), seed=0, conjugation=False):
        self.params, self.rparams = preset(name), ref_preset(name)
        self.rchest = rkeys.keygen(self.rparams, np.random.default_rng(seed),
                                   rotations=tuple(rotations), conjugation=conjugation)
        self.chest = interop.chest_from_reference(self.rchest, "cpu")
        self.ctx = make_context(self.params, device="cpu")
        self.be = DeviceBackend(self.params, self.ctx, self.chest)
        self.rbe = GoldenBackend(self.rparams, self.rchest)

    def encrypt(self, z, seed=2, level=None):
        """The same slots encrypted on both sides with the same draws."""
        z = np.asarray(z, dtype=np.complex128)
        if z.size < self.params.slots:
            z = np.concatenate([z, np.zeros(self.params.slots - z.size, np.complex128)])
        pt = penc.encode(z, self.params)
        ct = pct.encrypt(pt, self.params, self.chest.device_pk, self.ctx,
                         np.random.default_rng(seed), self.params.scale, level=level)
        rct = rgckks.encrypt(pt, self.rparams, self.rchest.pk, np.random.default_rng(seed),
                             self.params.scale, level=level)
        return ct, rct


def assert_ct_equal(got, want):
    assert got.level == want.level and len(got.c) == len(want.c)
    assert abs(got.scale / want.scale - 1.0) < 1e-12
    for g, w in zip(got.c, want.c):
        assert (g.numpy() == np.asarray(w).astype(np.int64)).all()


def decoded(pair, ct, k):
    return np.real(pair.be.decrypt_decode(ct))[:k]


# -- the MLP: plans from the block, the forward, the refresh ----------------


@pytest.fixture(scope="module")
def small():
    """ci_small with the rotations the MLP, CNN and logreg tests need."""
    rng = np.random.default_rng(1)
    w1, b1 = rng.normal(size=(8, 12)) * 0.3, rng.normal(size=8) * 0.3
    w2, b2 = rng.normal(size=(4, 8)) * 0.3, rng.normal(size=4) * 0.3
    layers = [(w1, b1), (w2, b2)]
    x = rng.normal(size=12) * 0.5
    slots = preset("ci_small").slots
    rots = sorted(set(rmlp.mlp_rotations(slots)) | set(rlogreg.rotations_needed(slots))
                  | set(rtrain.train_rotations(slots)))
    return Pair("ci_small", rots), layers, x


@pytest.mark.parametrize("shape", [(8, 12), (4, 8), (30, 200), (200, 30), (128, 128)])
def test_block_plan_equals_dense_plan(small, shape):
    pair = small[0]
    slots, level = pair.params.slots, pair.params.num_limbs
    rng = np.random.default_rng(shape[0] * 1000 + shape[1])
    w = rng.normal(size=shape)
    w[rng.random(shape) < 0.3] = 0.0  # zeros that empty some diagonals
    block = BsgsPlan._from_block(pair.be, w, level)
    dense = BsgsPlan(pair.be, pmlp._embed(w, slots), None, level)
    assert list(block.pt) == list(dense.pt)
    for key, (pt, scale) in dense.pt.items():
        assert block.pt[key][1] == scale
        assert (block.pt[key][0] == pt).all()
    assert (block.g, block.n_giant, block.level, block.scale, block.has_conj) == (
        dense.g, dense.n_giant, dense.level, dense.scale, dense.has_conj)


def test_mlp_builds_its_plans_from_the_block(small, monkeypatch):
    """The port's EncryptedMLP never forms the slots x slots embedding."""
    pair, layers, x = small
    monkeypatch.setattr(pmlp, "_embed", None)
    model = pmlp.EncryptedMLP(pair.be, layers)
    ct, _ = pair.encrypt(x)
    model(ct)
    assert len(model._plans) == 2


def test_mlp_matches_reference(small):
    pair, layers, x = small
    model = pmlp.EncryptedMLP(pair.be, layers)
    rmodel = LiftedMLP(pair.rbe, layers)
    assert model.levels_used == rmodel.levels_used == 3
    ct, rct = pair.encrypt(x)
    out = model(ct)
    assert_ct_equal(out, rmodel(rct))
    assert model.lift == rmodel.lift == 256
    # tests/test_models_utils.py:73
    assert np.abs(decoded(pair, out, 4) - rmodel.reference(x)).max() < 1e-2
    for i in range(2):  # the block-built plans == the reference's dense ones
        lvl = next(k[1] for k in model._plans if k[0] == i)
        got, want = model._plans[(i, lvl)].pt, rmodel._plans[(i, lvl)].pt
        assert list(got) == list(want)
        for key, (pt, scale) in want.items():
            assert got[key][1] == scale
            assert (pt_limbs(pair, got[key][0]) == np.asarray(pt).astype(np.int64)).all()


def test_mlp_at_its_lowest_level_is_the_reference(small):
    """Entered at levels_used + 1 the forward has no limb to spare for a
    lift (models/mlp.py _lift_of): == the reference's own EncryptedMLP."""
    pair, layers, x = small
    model = pmlp.EncryptedMLP(pair.be, layers)
    rmodel = rmlp.EncryptedMLP(pair.rbe, layers)
    ct, rct = pair.encrypt(x, level=model.levels_used + 1)
    out = model(ct)
    assert model.lift == 1 and out.level == 1
    assert_ct_equal(out, rmodel(rct))
    # tests/test_models_utils.py:73
    assert np.abs(decoded(pair, out, 4) - rmodel.reference(x)).max() < 1e-2


def pt_limbs(pair, pt_mont):
    """A port plaintext (Montgomery NTT domain) as canonical NTT limbs, the
    reference GoldenBackend's form."""
    from gpufhe_tpu_torch.ops.modops import from_mont

    rows = range(pt_mont.shape[0])
    return from_mont(pt_mont, pair.ctx.col("q", rows), pair.ctx.col("qinv_neg", rows)).numpy()


def test_mlp_rotations_match_reference(small):
    _, layers, _ = small
    for slots in (64, 512, 16384):
        assert pmlp.mlp_rotations_for(layers, slots) == rmlp.mlp_rotations_for(layers, slots)
        assert pmlp.mlp_rotations(slots) == rmlp.mlp_rotations(slots)
    mnist = [(np.ones((128, 784)), np.zeros(128)), (np.ones((10, 128)), np.zeros(10))]
    assert pmlp.mlp_rotations_for(mnist, 16384) == rmlp.mlp_rotations_for(mnist, 16384)


def test_mlp_refresh_matches_reference():
    """tests/test_bootstrap.py:116's deep MLP at boot_ci_deep: the input
    carries 3 levels, the forward bootstraps between layers (dense
    Bootstrapper), every output and the refresh count == the reference's."""
    params = preset("boot_ci_deep")
    rots = sorted(set(bootstrap_rotations(ref_preset("boot_ci_deep")))
                  | set(rmlp.mlp_rotations(params.slots)))
    pair = Pair("boot_ci_deep", rots, seed=7, conjugation=True)
    rng = np.random.default_rng(1)
    layers = [(rng.normal(size=(4 if i == 2 else 8, 8)) * 0.3,
               rng.normal(size=4 if i == 2 else 8) * 0.1) for i in range(3)]
    model = pmlp.EncryptedMLP(pair.be, layers, refresh=Bootstrapper(pair.be))
    rmodel = rmlp.EncryptedMLP(pair.rbe, layers, refresh=RefBootstrapper(pair.rbe))
    x = rng.normal(size=8) * 0.3
    ct, rct = pair.encrypt(x, level=3)
    out = model(ct)
    assert_ct_equal(out, rmodel(rct))
    assert model.refreshes == rmodel.refreshes >= 1
    # tests/test_bootstrap.py:158
    assert np.abs(decoded(pair, out, 4) - rmodel.reference(x)).max() < 0.05


# -- CNN, linear layer, logistic regression, training -----------------------


def test_cnn_matches_reference(small):
    """tests/test_cnn.py:41: conv(2ch 3x3) -> avgpool -> square -> dense."""
    pair = small[0]
    rng = np.random.default_rng(1)
    kernels, bias = rng.normal(size=(2, 1, 3, 3)) * 0.4, rng.normal(size=2) * 0.2
    dense_w, dense_b = rng.normal(size=(4, 18)) * 0.3, rng.normal(size=4) * 0.2
    img = (rng.normal(size=(1, 8, 8)) * 0.5).reshape(-1)
    model = pcnn.EncryptedCNN(pair.be, kernels, bias, (8, 8), dense_w, dense_b)
    rmodel = rcnn.EncryptedCNN(pair.rbe, kernels, bias, (8, 8), dense_w, dense_b)
    for a, b in zip(pcnn.compile_cnn(kernels, bias, (8, 8), dense_w, dense_b),
                    rcnn.compile_cnn(kernels, bias, (8, 8), dense_w, dense_b)):
        assert (a[0] == b[0]).all() and (a[1] == b[1]).all()
    ct, rct = pair.encrypt(img)
    out = model(ct)
    lifted = LiftedMLP(pair.rbe, rcnn.compile_cnn(kernels, bias, (8, 8), dense_w, dense_b))
    assert_ct_equal(out, lifted(rct))
    assert model.mlp.lift == lifted.lift == 256
    # tests/test_cnn.py:81
    assert np.abs(decoded(pair, out, 4) - rmodel.reference(img)).max() < 1e-2


def test_linear_matches_reference():
    pair = Pair("tiny2", pmodels.mlp.mlp_rotations(128))
    rng = np.random.default_rng(3)
    w = np.zeros((128, 128))
    w[:6, :10] = rng.normal(size=(6, 10)) * 0.3
    x = rng.normal(size=10) * 0.5
    layer = plinear.EncryptedLinear(pair.be, w, b=0.25)
    rlayer = rlinear.EncryptedLinear(pair.rbe, w, b=0.25)
    assert plinear.EncryptedLinear.rotations(128) == rlinear.EncryptedLinear.rotations(128)
    ct, rct = pair.encrypt(x)
    out = layer(ct)
    assert_ct_equal(out, rlayer(rct))
    # tests/test_pipeline.py:109, the decode tolerance of one product
    assert np.abs(decoded(pair, out, 6) - (w[:6, :10] @ x + 0.25)).max() < 1e-2


def test_logreg_matches_reference(small):
    """tests/test_models_utils.py:15."""
    pair = small[0]
    rng = np.random.default_rng(1)
    w, b, x = rng.normal(size=10), float(rng.normal()), rng.normal(size=10)
    model, rmodel = plogreg.EncryptedLogReg(pair.be, w, b), rlogreg.EncryptedLogReg(pair.rbe, w, b)
    ct, rct = pair.encrypt(x)
    out = model(ct)
    assert_ct_equal(out, rmodel(rct))
    # tests/test_models_utils.py:36
    assert abs(decoded(pair, out, 1)[0] - rmodel.reference_poly(x)) < 2e-3
    assert plogreg.rotations_needed(512) == rlogreg.rotations_needed(512)


def test_logreg_training_step_matches_reference(small):
    """tests/test_logreg_train.py:61: one gradient-descent step on encrypted
    columns, labels and weights. The port evaluates the reference's update
    in another order (lr/m after the SlotSum, the cubic in two levels;
    models/logreg_train.py), so its trainer runs on both backends: the
    port's DeviceBackend == the reference's GoldenBackend limb for limb;
    the decoded weights match the reference's own trainer on the same
    ciphertexts and the reference's cleartext mirror."""
    pair = small[0]
    rng = np.random.default_rng(5)
    m, f = 24, 3
    x = rng.normal(size=(m, f))
    y = (x @ rng.normal(size=f) > 0).astype(np.float64)
    w0 = rng.normal(size=f) * 0.1
    tr = ptrain.EncryptedLogRegTrainer(pair.be, n_samples=m, lr=1.0)
    rtr = rtrain.EncryptedLogRegTrainer(pair.rbe, n_samples=m, lr=1.0)
    ref_side = ptrain.EncryptedLogRegTrainer(pair.rbe, n_samples=m, lr=1.0)
    cols = [pair.encrypt(tr.slot_vec(x[:, j]), seed=10 + j) for j in range(f)]
    y_ct, ry_ct = pair.encrypt(tr.slot_vec(y), seed=20)
    ws = [pair.encrypt(np.full(pair.params.slots, w0[j]), seed=30 + j) for j in range(f)]
    out = tr.fit([w for w, _ in ws], [c for c, _ in cols], y_ct, iters=1)
    rout = ref_side.fit([w for _, w in ws], [c for _, c in cols], ry_ct, iters=1)
    for got, want in zip(out, rout):
        assert_ct_equal(got, want)
    # the weights land at exactly the parameters' scale, so steps compose
    assert all(w.scale == pair.params.scale for w in out)
    got = np.array([decoded(pair, w, 1)[0] for w in out])
    jout = rtr.fit([w for _, w in ws], [c for _, c in cols], ry_ct, iters=1)
    want = np.array([np.real(pair.rbe.decrypt_decode(w))[0] for w in jout])
    # the same update from the same ciphertexts in two orders: held to the
    # reference's own tolerance for one decoded step (its order reads 5.2e-4
    # from the cleartext here, the port's 3.7e-5)
    assert np.abs(got - want).max() < 1e-3
    # tests/test_logreg_train.py:75
    assert np.abs(got - rtr.reference(w0, x, y, 1)).max() < 1e-3
    assert ptrain.train_rotations(512) == rtrain.train_rotations(512)
    assert (ptrain.sigmoid_poly(np.linspace(-2, 2, 9))
            == rtrain.sigmoid_poly(np.linspace(-2, 2, 9))).all()


# -- attention and the transformer block ------------------------------------

D, T = 8, 8


def test_attention_matches_reference():
    """tests/test_attention.py:36 at ci_attn."""
    slots = preset("ci_attn").slots
    assert patt.attention_rotations(slots, D) == ratt.attention_rotations(slots, D)
    pair = Pair("ci_attn", patt.attention_rotations(slots, D))
    rng = np.random.default_rng(1)
    x = rng.uniform(-0.5, 0.5, size=(T, D))
    wq, wk, wv, wo = (rng.uniform(-0.4, 0.4, size=(D, D)) for _ in range(4))
    head = patt.EncryptedAttention(pair.be, wq, wk, wv, wo=wo, seq_len=T)
    rhead = ratt.EncryptedAttention(pair.rbe, wq, wk, wv, wo=wo, seq_len=T)
    ct, rct = pair.encrypt(x.reshape(-1))
    out = head(ct)
    assert_ct_equal(out, rhead(rct))
    want = ratt.attention_reference(x, wq, wk, wv, wo=wo)
    assert (patt.attention_reference(x, wq, wk, wv, wo=wo) == want).all()
    # tests/test_attention.py:52
    assert np.abs(decoded(pair, out, D) - want).max() < 2e-2


def test_transformer_block_matches_reference():
    """tests/test_transformer.py:24 at ci_xf."""
    slots = preset("ci_xf").slots
    assert pxf.transformer_rotations(slots, D) == rxf.transformer_rotations(slots, D)
    pair = Pair("ci_xf", pxf.transformer_rotations(slots, D))
    rng = np.random.default_rng(1)
    x = rng.uniform(-0.5, 0.5, size=(T, D))
    wq, wk, wv, wo = (rng.uniform(-0.4, 0.4, size=(D, D)) for _ in range(4))
    w1, w2 = rng.uniform(-0.3, 0.3, size=(16, D)), rng.uniform(-0.3, 0.3, size=(D, 16))
    b1, b2 = rng.uniform(-0.1, 0.1, size=16), rng.uniform(-0.1, 0.1, size=D)
    g1, g2 = (rng.uniform(0.8, 1.2, size=D) for _ in range(2))
    be1, be2 = (rng.uniform(-0.2, 0.2, size=D) for _ in range(2))
    args = ((wq, wk, wv, wo), (w1, b1, w2, b2))
    kw = dict(ln_weights=(g1, be1, g2, be2), seq_len=T, ln_iters=5)
    block = pxf.EncryptedTransformerBlock(pair.be, *args, **kw)
    rblock = rxf.EncryptedTransformerBlock(pair.rbe, *args, **kw)
    ct, rct = pair.encrypt(x.reshape(-1))
    out = block(ct)
    assert_ct_equal(out, rblock(rct))
    # tests/test_transformer.py:56
    assert np.abs(decoded(pair, out, D) - rblock.reference(x)).max() < 5e-2


# -- PIR over the integer schemes --------------------------------------------


@pytest.mark.parametrize("scheme", ["bgv", "bfv"])
def test_pir_matches_reference(scheme):
    """tests/test_pir.py:12: a one-hot query through one BSGS product, every
    retrieved record exact, the limbs == the reference's."""
    name = "bgv_tiny" if scheme == "bgv" else "bfv_tiny"
    params, rparams = preset(name), ref_preset(name)
    rmod, rgold, rback = (rbgv, rgbgv, rbgvb) if scheme == "bgv" else (rbfv, rgbfv, rbfvb)
    pmod, pback = (pbgv, pbgvb) if scheme == "bgv" else (pbfv, pbfvb)
    rots = ppir.pir_rotations(params.slots)
    assert rots == rpir.pir_rotations(params.slots)
    rchest = rmod.keygen(rparams, np.random.default_rng(3), rotations=rots)
    chest = interop.chest_from_reference(rchest, "cpu")
    ctx = make_context(params, device="cpu")
    be = getattr(pback, f"{scheme.upper()}DeviceBackend")(params, ctx, chest)
    rbe = getattr(rback, f"{scheme.upper()}GoldenBackend")(rparams, rchest)
    t = params.plain_modulus
    rng = np.random.default_rng(4)
    rows, cols = 5, 6
    db = rng.integers(0, t, size=(rows, cols), dtype=np.int64)
    assert (ppir.pir_matrix(db, params.slots) == rpir.pir_matrix(db, params.slots)).all()
    for index in (0, 3):
        q = ppir.encode_query(be, index, rows)
        assert (q == rpir.encode_query(rbe, index, rows)).all()
        pt = rgold.encode(rbgvb._orbit_to_raw(q, rbe.rings, t, params.n), rparams)
        ct = pmod.encrypt(pt, params, chest.device_pk, ctx, np.random.default_rng(5 + index))
        rct = rgold.encrypt(pt, rparams, rchest.pk, np.random.default_rng(5 + index))
        out, rout = ppir.pir_retrieve(be, ct, db), rpir.pir_retrieve(rbe, rct, db)
        assert out.level == rout.level
        assert getattr(out, "pt_factor", None) == getattr(rout, "pt_factor", None)
        for g, w in zip(out.c, rout.c):
            assert (g.numpy() == np.asarray(w).astype(np.int64)).all()
        got = be.decrypt_decode(out)[0][:cols]
        assert (got == db[index]).all()  # tests/test_pir.py:45
