"""One rank of the port's landmark-sharded bundle adjustment over
``torch.distributed`` with the gloo backend, on the CPU.

    python tests/torch_ba_worker.py RANK WORLD PORT IN.npz OUT.npz ITERS

Reads the whole sharded problem (``ba.distributed.shard_problem``'s result,
the leaves as arrays named by field) from IN.npz, takes shard RANK, runs
``ba.distributed.optimize`` over the WORLD ranks (rendezvous at
tcp://localhost:PORT) and writes its shard's poses, inverse depths and the
cost history to OUT.npz.  Imports no JAX: tests/test_torch_ba.py launches
WORLD of these and holds their result to the JAX package's.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    rank, world, port = (int(a) for a in sys.argv[1:4])
    src, dst, iters = sys.argv[4], sys.argv[5], int(sys.argv[6])
    import torch
    import torch.distributed as dist

    from rebvio_tpu_torch import interop
    from rebvio_tpu_torch.ba import distributed as tbd

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank)
    try:
        with np.load(src) as z:
            p = interop.ba_problem_from_numpy(dict(z), device="cpu")
        p_fin, hist = tbd.optimize(tbd.local_shard(p, rank, world), iters=iters)
        np.savez(dst, R=p_fin.R.numpy(), t=p_fin.t.numpy(), rho=p_fin.rho.numpy(),
                 obs_lm=p_fin.obs_lm.numpy(), hist=hist.numpy())
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
