"""gpufhe_tpu_torch.parallel.multihost: the limb axis across processes.

The counterpart of scripts/multihost_test.py: two processes join a gloo
process group on 127.0.0.1 (initialize_multihost), each holding one limb
row of two "cpu" shards of a 2 x 2 mesh (global_fhe_mesh), and run the
sharded multiply at tiny2; the key switch's exact modular allreduce over
the limb axis crosses the process boundary (torch.distributed.all_gather,
then add_mod in rank order). Rank 0's output == the single-process
multiply and == ct_mul. One process is the degenerate case: no process
group, every row local.

    python tests/test_torch_multihost.py <rank> <port>    (one worker)
"""

import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
NPROC = 2


def _operands():
    from gpufhe_tpu_torch.ciphertext import ct as dct
    from gpufhe_tpu_torch.encoding import encoder
    from gpufhe_tpu_torch.keys import keys as dkeys
    from gpufhe_tpu_torch.ops.context import make_context
    from gpufhe_tpu_torch.params.params import preset

    params = preset("tiny2")
    ctx = make_context(params, device="cpu")
    chest = dkeys.keygen(params, np.random.default_rng(7), ctx=ctx)
    z = np.random.default_rng(5).normal(size=(params.slots, 2)) @ np.array([1, 1j])
    ct = dct.encrypt(encoder.encode(z, params), params, chest.device_pk, ctx,
                     np.random.default_rng(61), params.scale)
    return params, ctx, chest, ct


def _sharded_mult(mesh, params, chest, ct):
    from gpufhe_tpu_torch.parallel import sharded as sh

    run, prepare = sh.make_sharded_mult(params, ct.level, mesh)
    blocks = [sh.shard_ct_component(c, params, mesh) for c in ct.c + ct.c]
    return [sh.unshard_ct_component(o) for o in run(*blocks, prepare(chest.device_rlk))]


def worker(rank: int, port: int) -> None:
    import torch.distributed as dist

    from gpufhe_tpu_torch.ciphertext import ct as dct
    from gpufhe_tpu_torch.parallel import multihost, sharded as sh

    torch.set_num_threads(1)
    multihost.initialize_multihost(f"127.0.0.1:{port}", NPROC, rank)
    mesh = multihost.global_fhe_mesh(devices=["cpu", "cpu"])
    assert mesh.distributed and mesh.shape == {"limb": 2, "coeff": 2}
    assert mesh.rows == (rank,)
    params, ctx, chest, ct = _operands()
    got = _sharded_mult(mesh, params, chest, ct)
    if rank == 0:
        one = _sharded_mult(sh.make_fhe_mesh(2, 2, devices=["cpu"] * 4), params, chest, ct)
        want = dct.ct_mul(ct, ct, params, ctx, chest.device_rlk).c
        ok = all(torch.equal(g, o) and torch.equal(g, w) for g, o, w in zip(got, one, want))
        print(f"MULTIHOST_RESULT ok={ok} processes={dist.get_world_size()}", flush=True)
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_two_process_limb_axis_matches_one_process():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT), os.environ.get("PYTHONPATH", "")])}
    procs = [subprocess.Popen([sys.executable, __file__, str(rank), str(port)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env, cwd=ROOT) for rank in range(NPROC)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(outs)
    assert "MULTIHOST_RESULT ok=True processes=2" in outs[0], "\n".join(outs)


def test_one_process_is_the_degenerate_case():
    """No process group: initialize_multihost is a no-op, and
    global_fhe_mesh holds every limb row locally (and, without named
    devices, wants a card)."""
    from gpufhe_tpu_torch.parallel import multihost

    multihost.initialize_multihost(None, 1, 0)
    mesh = multihost.global_fhe_mesh(devices=["cpu"] * 4)
    assert mesh.shape == {"limb": 1, "coeff": 4} and not mesh.distributed
    mesh = multihost.global_fhe_mesh(limb_hosts=2, devices=["cpu"] * 4)
    assert mesh.shape == {"limb": 2, "coeff": 2} and mesh.rows == (0, 1)
    params, _, chest, ct = _operands()
    from gpufhe_tpu_torch.ciphertext import ct as dct
    from gpufhe_tpu_torch.ops.context import make_context

    want = dct.ct_mul(ct, ct, params, make_context(params, device="cpu"), chest.device_rlk).c
    assert all(torch.equal(g, w) for g, w in zip(_sharded_mult(mesh, params, chest, ct), want))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            multihost.global_fhe_mesh()


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    worker(int(sys.argv[1]), int(sys.argv[2]))
