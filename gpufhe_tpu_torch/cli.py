"""Command-line interface: kernel bounds / demos / security / bootstrap / keygen.

Counterpart of gpufhe_tpu/cli.py, with its subcommands, arguments and
defaults and the same JSON keys in each output line. Every context is built
on the card; `--cpu` builds every one on the CPU instead, where each kernel
runs its plain PyTorch version.

    python -m gpufhe_tpu_torch.cli bench --preset config5_boot
    python -m gpufhe_tpu_torch.cli kernels --preset config5_boot
    python -m gpufhe_tpu_torch.cli --cpu demo-logreg --preset ci_small
    python -m gpufhe_tpu_torch.cli keygen --preset config3_ckks --out keys.npz

`bench` runs gpufhe_tpu_torch/bench.py, the counterpart of the reference's
root bench.py: one JSON line per headline, the --preset multiply last.
`kernels` prints each row beside its bound on the card (utils/benchkit.py).
`scaling` reports the sharded multiply over the mesh shapes that fit the
distinct devices (parallel/multihost.py scaling_report): one card, or the
CPU, gives the 1 x 1 row alone. The reference's `--cache` (XLA's compile
cache) has no counterpart.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def _device(args) -> str:
    """Where every context of a command is built: the card, or the CPU
    under --cpu."""
    return "cpu" if args.cpu else "cuda"


def _ctx(params, args):
    from gpufhe_tpu_torch.ops.context import make_context

    return make_context(params, device=_device(args))


def _cmd_bench(args):
    import os

    from gpufhe_tpu_torch import bench

    os.environ.setdefault("BENCH_PRESET", args.preset)
    bench.main(device=_device(args))


def _cmd_demo_mlp(args):
    from gpufhe_tpu_torch.ciphertext import ct as dct
    from gpufhe_tpu_torch.ciphertext.backend import DeviceBackend
    from gpufhe_tpu_torch.encoding import encoder
    from gpufhe_tpu_torch.keys import keys as dkeys
    from gpufhe_tpu_torch.models.mlp import EncryptedMLP, mlp_rotations
    from gpufhe_tpu_torch.params.params import preset

    params = preset(args.preset)
    ctx = _ctx(params, args)
    chest = dkeys.keygen(
        params, np.random.default_rng(0),
        rotations=tuple(mlp_rotations(params.slots)), ctx=ctx,
    )
    be = DeviceBackend(params, ctx, chest)

    rng = np.random.default_rng(1)
    d_in, d_h, d_out = 12, 8, 4
    model = EncryptedMLP(be, [
        (rng.normal(size=(d_h, d_in)) * 0.3, rng.normal(size=d_h) * 0.3),
        (rng.normal(size=(d_out, d_h)) * 0.3, rng.normal(size=d_out) * 0.3),
    ])
    x = rng.normal(size=d_in) * 0.5
    slots_x = np.zeros(params.slots, dtype=np.complex128)
    slots_x[:d_in] = x
    ct = dct.encrypt(
        encoder.encode(slots_x, params), params, chest.device_pk, ctx,
        np.random.default_rng(2), params.scale,
    )
    got = np.real(be.decrypt_decode(model(ct))[:d_out])
    want = model.reference(x)
    print(json.dumps({
        "demo": "encrypted_mlp",
        "preset": args.preset,
        "dims": [d_in, d_h, d_out],
        "levels_used": model.levels_used,
        "encrypted_logits": [round(float(v), 6) for v in got],
        "cleartext_logits": [round(float(v), 6) for v in want],
        "max_abs_err": round(float(np.abs(got - want).max()), 6),
    }))


def _cmd_demo_deep_mlp(args):
    """MLP deeper than the level budget: bootstrap-refreshed mid-inference
    (models/mlp.py refresh=)."""
    from gpufhe_tpu_torch.ciphertext import ct as dct
    from gpufhe_tpu_torch.ciphertext.backend import DeviceBackend
    from gpufhe_tpu_torch.ciphertext.bootstrap import Bootstrapper, bootstrap_rotations
    from gpufhe_tpu_torch.encoding import encoder
    from gpufhe_tpu_torch.keys import keys as dkeys
    from gpufhe_tpu_torch.models.mlp import EncryptedMLP, mlp_rotations
    from gpufhe_tpu_torch.params.params import preset

    params = preset(args.preset)
    ctx = _ctx(params, args)
    rots = sorted(
        set(bootstrap_rotations(params)) | set(mlp_rotations(params.slots))
    )
    chest = dkeys.keygen(
        params, np.random.default_rng(0), rotations=tuple(rots), conjugation=True, ctx=ctx
    )
    be = DeviceBackend(params, ctx, chest)
    bs = Bootstrapper(be)

    rng = np.random.default_rng(1)
    d, d_out = 8, 4
    layers = []
    for i in range(args.layers):
        o = d_out if i == args.layers - 1 else d
        layers.append((rng.normal(size=(o, d)) * 0.3, rng.normal(size=o) * 0.1))
    model = EncryptedMLP(be, layers, refresh=bs)

    x = rng.normal(size=d) * 0.3
    slots_x = np.zeros(params.slots, dtype=np.complex128)
    slots_x[:d] = x
    ct = dct.encrypt(
        encoder.encode(slots_x, params), params, chest.device_pk, ctx,
        np.random.default_rng(2), params.scale, level=3,
    )
    got = np.real(be.decrypt_decode(model(ct))[:d_out])
    want = model.reference(x)
    print(json.dumps({
        "demo": "deep_mlp_mid_inference_bootstrap",
        "preset": args.preset,
        "n_layers": args.layers,
        "levels_needed": model.levels_used,
        "input_level": 3,
        "mid_inference_bootstraps": model.refreshes,
        "encrypted_logits": [round(float(v), 6) for v in got],
        "cleartext_logits": [round(float(v), 6) for v in want],
        "max_abs_err": round(float(np.abs(got - want).max()), 6),
    }))


def _cmd_demo_train(args):
    """Logistic-regression training on encrypted data with encrypted
    weights; bootstraps the weights mid-run when iterations exceed the
    chain (models/logreg_train.py)."""
    from gpufhe_tpu_torch.ciphertext import ct as dct
    from gpufhe_tpu_torch.ciphertext.backend import DeviceBackend
    from gpufhe_tpu_torch.ciphertext.bootstrap import Bootstrapper, bootstrap_rotations
    from gpufhe_tpu_torch.encoding import encoder
    from gpufhe_tpu_torch.keys import keys as dkeys
    from gpufhe_tpu_torch.models.logreg_train import (
        EncryptedLogRegTrainer, sigmoid_poly, train_rotations,
    )
    from gpufhe_tpu_torch.params.params import preset

    params = preset(args.preset)
    ctx = _ctx(params, args)
    rots = set(train_rotations(params.slots))
    refresh_ok = args.iters * 5 * params.scale_words >= params.num_limbs
    if refresh_ok:
        rots |= set(bootstrap_rotations(params))
    chest = dkeys.keygen(
        params, np.random.default_rng(0), rotations=tuple(sorted(rots)),
        conjugation=refresh_ok, ctx=ctx,
    )
    be = DeviceBackend(params, ctx, chest)
    bs = Bootstrapper(be) if refresh_ok else None

    rng = np.random.default_rng(1)
    m, f = 32, 2
    x = rng.normal(size=(m, f))
    true_w = rng.normal(size=f)
    y = (x @ true_w > 0).astype(np.float64)
    tr = EncryptedLogRegTrainer(be, n_samples=m, lr=1.0, refresh=bs)

    def enc(v, seed, lv):
        return dct.encrypt(
            encoder.encode(v, params), params, chest.device_pk, ctx,
            np.random.default_rng(seed), params.scale, level=lv,
        )

    full = params.num_limbs
    x_cts = [enc(tr.slot_vec(x[:, j]), 10 + j, full) for j in range(f)]
    y_ct = enc(tr.slot_vec(y), 20, full)
    w_cts = [
        enc(np.zeros(params.slots, dtype=np.complex128), 30 + j, full)
        for j in range(f)
    ]
    w_out = tr.fit(w_cts, x_cts, y_ct, iters=args.iters)
    got = np.array([float(np.real(be.decrypt_decode(w)[0])) for w in w_out])
    want = tr.reference(np.zeros(f), x, y, iters=args.iters)
    acc = float(np.mean((sigmoid_poly(x @ got) > 0.5) == (y > 0.5)))
    print(json.dumps({
        "demo": "encrypted_logreg_training",
        "preset": args.preset,
        "samples": m, "features": f, "iters": args.iters,
        "weight_bootstraps": tr.refreshes,
        "encrypted_weights": [round(float(v), 6) for v in got],
        "cleartext_weights": [round(float(v), 6) for v in want],
        "max_abs_err": round(float(np.abs(got - want).max()), 6),
        "train_accuracy": acc,
    }))


def _cmd_kernels(args):
    """The reference's kernel rows, timed on the device, each beside its
    bound on the card (utils/benchkit.py bench_all; no bound under --cpu)."""
    from gpufhe_tpu_torch.utils.benchkit import bench_all

    for row in bench_all(args.preset, device=_device(args)):
        print(json.dumps(row))


def _cmd_demo_logreg(args):
    from gpufhe_tpu_torch.ciphertext import ct as dct
    from gpufhe_tpu_torch.ciphertext.backend import DeviceBackend
    from gpufhe_tpu_torch.encoding import encoder
    from gpufhe_tpu_torch.keys import keys as dkeys
    from gpufhe_tpu_torch.models.logreg import EncryptedLogReg, rotations_needed
    from gpufhe_tpu_torch.params.params import preset

    params = preset(args.preset)
    ctx = _ctx(params, args)
    rots = rotations_needed(params.slots)
    chest = dkeys.keygen(params, np.random.default_rng(0), rotations=tuple(rots), ctx=ctx)
    be = DeviceBackend(params, ctx, chest)

    rng = np.random.default_rng(1)
    n_feat = 10
    w = rng.normal(size=n_feat)
    b = float(rng.normal())
    x = rng.normal(size=n_feat)
    model = EncryptedLogReg(be, w, b)

    slots_x = np.zeros(params.slots, dtype=np.complex128)
    slots_x[:n_feat] = x
    ct = dct.encrypt(
        encoder.encode(slots_x, params), params, chest.device_pk, ctx,
        np.random.default_rng(2), params.scale,
    )
    out = model(ct)
    got = float(np.real(be.decrypt_decode(out)[0]))
    want = model.reference(x)
    print(json.dumps({
        "demo": "encrypted_logreg",
        "preset": args.preset,
        "encrypted_score": round(got, 6),
        "cleartext_score": round(want, 6),
        "abs_err": round(abs(got - want), 6),
    }))


def _integer_matvec(args, scheme: str):
    """The shared set-up of demo-bgv and demo-bfv: keys with the BSGS
    rotations, a random matrix mod t, one vector per slot ring encrypted,
    and A @ v mod t through linalg's matmul. Returns (be, ct, out, got,
    want, v, params)."""
    from gpufhe_tpu_torch.ciphertext import linalg
    from gpufhe_tpu_torch.params.params import preset

    if scheme == "bgv":
        from gpufhe_tpu_torch.ciphertext import bgv as dev
        from gpufhe_tpu_torch.ciphertext.bgv_backend import BGVDeviceBackend as Backend
        from gpufhe_tpu_torch.golden import bgv as gold
    else:
        from gpufhe_tpu_torch.ciphertext import bfv as dev
        from gpufhe_tpu_torch.ciphertext.bfv_backend import BFVDeviceBackend as Backend
        from gpufhe_tpu_torch.golden import bfv as gold

    params = preset(args.preset)
    assert params.plain_modulus, f"{args.preset} is not a {scheme.upper()} preset"
    ctx = _ctx(params, args)
    n_s = params.slots
    rots = tuple(linalg.bsgs_rotations(n_s))
    chest = dev.keygen(params, np.random.default_rng(0), rotations=rots, ctx=ctx)
    t = params.plain_modulus

    rng = np.random.default_rng(1)
    a_mat = rng.integers(0, t, size=(n_s, n_s))
    v = rng.integers(0, t, size=(2, n_s))  # one vector per slot ring
    be = Backend(params, ctx, chest)
    raw = np.empty(params.n, dtype=np.int64)
    raw[be.rings[0]], raw[be.rings[1]] = v[0], v[1]
    ct = dev.encrypt(
        gold.encode(raw, params), params, chest.device_pk, ctx,
        np.random.default_rng(2),
    )
    out = linalg.matmul_plain(be, ct, a_mat)
    got = be.decrypt_decode(out)
    want = (a_mat.astype(object) @ v.T.astype(object) % t).T.astype(np.int64)
    return be, ct, out, got, want, v, params


def _cmd_demo_bgv(args):
    """Exact encrypted integer linear algebra: A @ v mod t on BGV slots."""
    _, _, _, got, want, _, params = _integer_matvec(args, "bgv")
    print(json.dumps({
        "demo": "bgv_exact_matvec",
        "preset": args.preset,
        "t": params.plain_modulus,
        "slots_per_ring": params.slots,
        "exact": bool((got == want).all()),
    }))


def _cmd_demo_attention(args):
    """Encrypted single-query attention head (models/attention.py)."""
    from gpufhe_tpu_torch.ciphertext import ct as dct
    from gpufhe_tpu_torch.ciphertext.backend import DeviceBackend
    from gpufhe_tpu_torch.encoding import encoder
    from gpufhe_tpu_torch.keys import keys as dkeys
    from gpufhe_tpu_torch.models.attention import (
        EncryptedAttention, attention_reference, attention_rotations)
    from gpufhe_tpu_torch.params.params import preset

    params = preset(args.preset)
    d, t = 8, 8
    ctx = _ctx(params, args)
    chest = dkeys.keygen(
        params, np.random.default_rng(0),
        rotations=tuple(attention_rotations(params.slots, d)), ctx=ctx,
    )
    be = DeviceBackend(params, ctx, chest)

    rng = np.random.default_rng(1)
    x = rng.uniform(-0.5, 0.5, size=(t, d))
    wq, wk, wv, wo = (rng.uniform(-0.4, 0.4, size=(d, d)) for _ in range(4))
    z = np.zeros(params.slots, dtype=np.complex128)
    z[: t * d] = x.reshape(-1)
    ct = dct.encrypt(
        encoder.encode(z, params), params, chest.device_pk, ctx,
        np.random.default_rng(2), params.scale,
    )
    head = EncryptedAttention(be, wq, wk, wv, wo=wo, seq_len=t)
    got = np.real(be.decrypt_decode(head(ct)))[:d]
    want = attention_reference(x, wq, wk, wv, wo=wo)
    print(json.dumps({
        "demo": "encrypted_attention",
        "preset": args.preset,
        "seq_len": t,
        "head_dim": d,
        "encrypted_out": [round(float(v), 6) for v in got],
        "cleartext_out": [round(float(v), 6) for v in want],
        "max_abs_err": round(float(np.abs(got - want).max()), 6),
    }))


def _cmd_demo_matmul(args):
    """Encrypted x encrypted matrix product (linalg.py CtMatmulPlan, JKLS)."""
    from gpufhe_tpu_torch.ciphertext import ct as dct
    from gpufhe_tpu_torch.ciphertext.backend import DeviceBackend
    from gpufhe_tpu_torch.ciphertext.linalg import (
        ct_matmul, ct_matmul_rotations, pack_matrix)
    from gpufhe_tpu_torch.encoding import encoder
    from gpufhe_tpu_torch.keys import keys as dkeys
    from gpufhe_tpu_torch.params.params import preset

    params = preset(args.preset)
    d = args.dim
    ctx = _ctx(params, args)
    chest = dkeys.keygen(
        params, np.random.default_rng(0),
        rotations=tuple(ct_matmul_rotations(params.slots, d)), ctx=ctx,
    )
    be = DeviceBackend(params, ctx, chest)

    rng = np.random.default_rng(1)
    a = rng.uniform(-0.5, 0.5, size=(d, d))
    b = rng.uniform(-0.5, 0.5, size=(d, d))

    def enc(m, seed):
        return dct.encrypt(
            encoder.encode(pack_matrix(m, params.slots), params), params,
            chest.device_pk, ctx, np.random.default_rng(seed), params.scale,
        )

    out = ct_matmul(be, enc(a, 2), enc(b, 3), d)
    got = np.real(be.decrypt_decode(out))[: d * d].reshape(d, d)
    want = a @ b
    print(json.dumps({
        "demo": "encrypted_ct_matmul",
        "preset": args.preset,
        "dim": d,
        "max_abs_err": round(float(np.abs(got - want).max()), 6),
        "levels_used": int(be.level(enc(a, 2)) - be.level(out)),
    }))


def _cmd_scaling(args):
    from gpufhe_tpu_torch.parallel.multihost import scaling_report
    from gpufhe_tpu_torch.params.params import preset

    shapes = []
    for spec in args.meshes.split(";"):
        l, c = spec.split("x")
        shapes.append((int(l), int(c)))
    for mode in args.modes.split(","):
        for row in scaling_report(preset(args.preset), shapes, iters=args.iters, mode=mode,
                                  device=_device(args)):
            print(json.dumps(row))


def _cmd_security(args):
    """HE-standard logQP budget report (utils/security.py)."""
    from gpufhe_tpu_torch.params.params import preset
    from gpufhe_tpu_torch.utils import security

    print(json.dumps({"preset": args.preset, **security.report(preset(args.preset))}))


def _cmd_demo_threshold(args):
    """Multiparty secure aggregation + a collaborative-relin multiply: the
    joint keys built on the host, the parties' ciphertexts encrypted, summed
    and squared on the device, the partials on the host."""
    from gpufhe_tpu_torch.ciphertext import ct as dct
    from gpufhe_tpu_torch.ciphertext import threshold as th
    from gpufhe_tpu_torch.golden import ckks as gckks
    from gpufhe_tpu_torch.keys.keys import upload_ks_key, upload_public_key
    from gpufhe_tpu_torch.params.params import preset

    params = preset(args.preset)
    ctx = _ctx(params, args)
    n_parties = args.parties
    a = th.common_a(params, seed=0)
    shares = [
        th.party_keygen(params, a, np.random.default_rng(100 + i))
        for i in range(n_parties)
    ]
    pk = upload_public_key(th.aggregate_public_key(params, a, [s.b for s in shares]),
                           params, ctx=ctx)
    rlk = upload_ks_key(th.collaborative_relin_key(params, shares, seed=1), params, ctx=ctx)

    rng = np.random.default_rng(2)
    vecs = [rng.uniform(-1, 1, size=params.slots) for _ in range(n_parties)]
    cts = [
        dct.encrypt(
            gckks.encode(v + 0j, params.scale, params.q_primes, params.n),
            params, pk, ctx, np.random.default_rng(10 + i), params.scale,
        )
        for i, v in enumerate(vecs)
    ]
    acc = cts[0]
    for ct in cts[1:]:
        acc = dct.ct_add(acc, ct, ctx)
    sq = dct.ct_mul(acc, acc, params, ctx, rlk)  # (sum)^2 via the collaborative rlk
    partials = [
        th.partial_decrypt(sq, params, s, np.random.default_rng(20 + i))
        for i, s in enumerate(shares)
    ]
    got = th.decrypt_ckks(sq, params, partials).real
    want = np.sum(vecs, axis=0) ** 2
    print(json.dumps({
        "demo": "threshold_secure_aggregation",
        "preset": args.preset,
        "parties": n_parties,
        "op": "square(sum of encrypted party vectors)",
        "abs_err": float(round(np.abs(got - want).max(), 6)),
    }))


def _cmd_demo_bfv(args):
    """Exact encrypted integer matvec + ct-ct multiply on BFV slots."""
    be, ct, out, got, want, v, params = _integer_matvec(args, "bfv")
    # scale-invariant ct-ct multiply: (A v) * v, then a modulus reduction
    # (mod-reduce the fresh ct down to the matvec's level first: BFV
    # modulus reduction keeps the plaintext intact)
    ct2 = ct
    while ct2.level > be.level(out):
        ct2 = be.rescale(ct2)
    sq = be.rescale(be.mul(out, ct2))
    got_sq = be.decrypt_decode(sq)
    want_sq = want * v % params.plain_modulus
    print(json.dumps({
        "demo": "bfv_exact_matvec_mult",
        "preset": args.preset,
        "t": params.plain_modulus,
        "slots_per_ring": params.slots,
        "matvec_exact": bool((got == want).all()),
        "mult_exact": bool((got_sq == want_sq).all()),
    }))


def _cmd_bootstrap(args):
    """Run one full CKKS bootstrap at the given preset (device keys)."""
    import time

    import torch

    from gpufhe_tpu_torch.ciphertext import ct as dct
    from gpufhe_tpu_torch.ciphertext.backend import DeviceBackend
    from gpufhe_tpu_torch.ciphertext.bootstrap import Bootstrapper, bootstrap_rotations
    from gpufhe_tpu_torch.encoding import encoder
    from gpufhe_tpu_torch.keys.device_keygen import device_keygen
    from gpufhe_tpu_torch.params.params import preset

    params = preset(args.preset)
    ctx = _ctx(params, args)
    rots = bootstrap_rotations(params, transform=args.transform, radix_log=args.radix)
    chest = device_keygen(
        params, np.random.default_rng(args.seed), rotations=tuple(rots),
        conjugation=True, ctx=ctx,
    )
    be = DeviceBackend(params, ctx, chest)
    bs = Bootstrapper(
        be, r=args.r, taylor_m=args.taylor_m, transform=args.transform,
        radix_log=args.radix, evalmod=args.evalmod, k_bound=args.k_bound,
    )
    rng = np.random.default_rng(0)
    z = (rng.normal(size=params.slots) + 1j * rng.normal(size=params.slots)) * 0.2
    ct = dct.encrypt(
        encoder.encode(z, params), params, chest.device_pk, ctx,
        np.random.default_rng(1), params.scale, level=1,
    )
    def sync():
        if ctx.device.type == "cuda":
            torch.cuda.synchronize()

    t0 = time.time()
    out = bs(ct)
    sync()
    first = time.time() - t0
    t0 = time.time()
    out = bs(ct)
    sync()
    steady = time.time() - t0
    err = float(np.abs(be.decrypt_decode(out) - z).max())
    print(json.dumps({
        "bootstrap": args.preset, "steady_s": round(steady, 3),
        "first_s": round(first, 1), "out_level": out.level, "max_err": err,
    }))


def _cmd_keygen(args):
    from gpufhe_tpu_torch.keys import keys as dkeys
    from gpufhe_tpu_torch.params.params import preset
    from gpufhe_tpu_torch.utils.serialization import save_keychest

    params = preset(args.preset)
    rots = tuple(int(r) for r in args.rotations.split(",")) if args.rotations else ()
    chest = dkeys.keygen(
        params, np.random.default_rng(args.seed), rotations=rots,
        conjugation=args.conjugation, ctx=_ctx(params, args),
    )
    save_keychest(args.out, chest)
    print(json.dumps({"written": args.out, "preset": args.preset, "rotations": rots}))


def main(argv=None):
    p = argparse.ArgumentParser(prog="gpufhe_tpu_torch")
    p.add_argument("--cpu", action="store_true",
                   help="build every context on the CPU (each kernel's plain "
                        "PyTorch version) instead of the card")
    sub = p.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("bench", help="headline benchmark lines, the --preset multiply last")
    b.add_argument("--preset", default="config5_boot")
    b.set_defaults(fn=_cmd_bench)

    k = sub.add_parser("kernels", help="per-kernel times beside their bounds on the card")
    k.add_argument("--preset", default="config5_boot")
    k.set_defaults(fn=_cmd_kernels)

    dm = sub.add_parser("demo-mlp", help="encrypted MLP inference demo")
    dm.add_argument("--preset", default="ci_small")
    dm.set_defaults(fn=_cmd_demo_mlp)

    dd = sub.add_parser(
        "demo-deep-mlp",
        help="MLP deeper than the level budget: bootstraps mid-inference",
    )
    dd.add_argument("--preset", default="boot_ci_deep")
    dd.add_argument("--layers", type=int, default=3)
    dd.set_defaults(fn=_cmd_demo_deep_mlp)

    dt = sub.add_parser(
        "demo-train",
        help="train logreg on encrypted data/weights (bootstraps mid-run)",
    )
    dt.add_argument("--preset", default="ci_deep")
    dt.add_argument("--iters", type=int, default=2)
    dt.set_defaults(fn=_cmd_demo_train)

    d = sub.add_parser("demo-logreg", help="encrypted logistic regression demo")
    d.add_argument("--preset", default="ci_small")
    d.set_defaults(fn=_cmd_demo_logreg)

    bg = sub.add_parser(
        "demo-bgv", help="exact encrypted integer matvec on BGV slots"
    )
    bg.add_argument("--preset", default="bgv_tiny")
    bg.set_defaults(fn=_cmd_demo_bgv)

    bf = sub.add_parser(
        "demo-bfv", help="exact encrypted integer matvec + mult on BFV slots"
    )
    bf.add_argument("--preset", default="bfv_tiny")
    bf.set_defaults(fn=_cmd_demo_bfv)

    thp = sub.add_parser(
        "demo-threshold", help="multiparty secure aggregation (threshold FHE)"
    )
    thp.add_argument("--preset", default="tiny2")
    thp.add_argument("--parties", type=int, default=3)
    thp.set_defaults(fn=_cmd_demo_threshold)

    at = sub.add_parser(
        "demo-attention",
        help="encrypted single-query attention head (softmax under CKKS)",
    )
    at.add_argument("--preset", default="ci_attn")
    at.set_defaults(fn=_cmd_demo_attention)

    mm = sub.add_parser(
        "demo-matmul",
        help="encrypted x encrypted matrix product (JKLS, 3 levels)",
    )
    mm.add_argument("--preset", default="ci_attn")
    mm.add_argument("--dim", type=int, default=8)
    mm.set_defaults(fn=_cmd_demo_matmul)

    sec = sub.add_parser(
        "security", help="HE-standard security report for a preset"
    )
    sec.add_argument("--preset", default="config5_boot_dw")
    sec.set_defaults(fn=_cmd_security)

    w = sub.add_parser("scaling", help="sharded-mult scaling report over mesh shapes")
    w.add_argument("--preset", default="tiny2")
    w.add_argument("--meshes", default="1x1;1x2;2x2;2x4")
    w.add_argument("--iters", type=int, default=5)
    w.add_argument("--modes", default="strong,weak",
                   help="comma list of strong|weak")
    w.set_defaults(fn=_cmd_scaling)

    bt = sub.add_parser("bootstrap", help="run one full CKKS bootstrap")
    bt.add_argument("--preset", default="boot_ci_f")
    bt.add_argument("--transform", default="factored", choices=["dense", "factored"])
    bt.add_argument("--radix", type=int, default=3)
    bt.add_argument("--r", type=int, default=5)
    bt.add_argument("--taylor-m", dest="taylor_m", type=int, default=4)
    bt.add_argument("--seed", type=int, default=7)
    bt.add_argument("--evalmod", default="cos", choices=["cos", "cheb"])
    bt.add_argument("--k-bound", dest="k_bound", type=float, default=12.0)
    bt.set_defaults(fn=_cmd_bootstrap)

    g = sub.add_parser("keygen", help="generate + save a key chest")
    g.add_argument("--preset", default="config3_ckks")
    g.add_argument("--out", default="keys.npz")
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--rotations", default="")
    g.add_argument("--conjugation", action="store_true")
    g.set_defaults(fn=_cmd_keygen)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
