"""Time-sharded filterbank battery (BASELINE config #5) over a device
mesh on the PyTorch port: PQMF / IPQMF and MDCT / IMDCT round trips on
multi-channel audio with the waveform split over time blocks; the
counterpart of examples/sharded_filterbanks.py.

    python examples/torch_sharded_filterbanks.py [--wav in.wav]
        [--ranks N] [--mesh DP TP] [--device cpu]

One process a rank, joined by torch.distributed on a (dp, tp) mesh
(diffsptk_tpu_torch.parallel): on the card one NCCL rank a card (all of
them unless ``--ranks``), with ``--device cpu`` ``--ranks`` gloo ranks (2
by default).  Four channels (``--wav`` four times, or synthetic speech
from ``--seed`` .. ``--seed`` + 3) are cut over dp by channel and over tp
in time; rank 0 holds the gathered outputs against the unsharded
transforms.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch

import diffsptk_tpu_torch as pt
from diffsptk_tpu_torch.parallel.ranks import spawn_ranks
from torch_common import parser, rank_count, speech

CHANNELS = 4
L, K, M = 256, 4, 47


def worker(rank: int, world: int, device: str, args, mesh_shape):
    from diffsptk_tpu_torch.parallel import make_mesh, shard, unshard
    from diffsptk_tpu_torch.parallel.filterbanks import (ShardedIMDCT,
                                                         ShardedIPQMF,
                                                         ShardedMDCT,
                                                         ShardedPQMF)

    mesh = make_mesh(mesh_shape, device_type=device)
    dev = torch.device(device, rank) if device == "cuda" else "cpu"
    x, _ = speech(args, dev, rows=CHANNELS)
    T = x.shape[-1] - x.shape[-1] % (128 * mesh_shape[1])
    x = x[:, :T].contiguous()
    place = dict(device=dev, dtype=torch.float32)
    with torch.no_grad():
        xb = shard(x, mesh)
        y_md = unshard(ShardedIMDCT(mesh, L, **place)(
            ShardedMDCT(mesh, L, **place)(xb), out_length=T), mesh)
        y_pq = unshard(ShardedIPQMF(mesh, K, M, **place)(
            ShardedPQMF(mesh, K, M, **place)(xb))[..., 0, :], mesh)
        if rank:
            return None
        ref_md = pt.IMDCT(L, **place)(pt.MDCT(L, **place)(x), out_length=T)
        ref_pq = pt.IPQMF(K, M, **place)(pt.PQMF(K, M, **place)(x))[..., 0, :]
    x64 = x.double()
    snr = float(10 * torch.log10((x64 ** 2).sum()
                                 / ((y_md.double() - x64) ** 2).sum()))
    return (snr, float((y_md - ref_md).abs().max()),
            float((y_pq - ref_pq).abs().max()))


def main(argv=None) -> tuple:
    ap = parser(__doc__, length=76800)
    ap.add_argument("--ranks", type=int, default=None)
    ap.add_argument("--mesh", type=int, nargs=2, default=None,
                    metavar=("DP", "TP"),
                    help="mesh shape (default: 1 x ranks)")
    args = ap.parse_args(argv)
    ranks, device = rank_count(args)
    mesh_shape = tuple(args.mesh) if args.mesh else (1, ranks)
    snr, err_md, err_pq = spawn_ranks(worker, ranks, device, args, mesh_shape)
    print(f"mesh=({mesh_shape[0]}x{mesh_shape[1]}), {ranks} {device} ranks: "
          f"MDCT round-trip SNR {snr:.1f} dB")
    print(f"sharded == unsharded: MDCT leg {err_md:.2e}, PQMF leg "
          f"{err_pq:.2e}")
    return snr, err_md, err_pq


if __name__ == "__main__":
    np.seterr(all="ignore")
    main()
