"""Sequence-parallel mel-cepstral vocoder over a device mesh on the
PyTorch port: the counterpart of examples/sharded_vocoder.py.

    python examples/torch_sharded_vocoder.py [--wav in.wav]
        [--ranks N] [--mesh DP TP] [--device cpu]

One process a rank, joined by torch.distributed on a (dp, tp) mesh
(diffsptk_tpu_torch.parallel): on the card one NCCL rank a card (all of
them unless ``--ranks``), with ``--device cpu`` ``--ranks`` gloo ranks (2
by default).  Four rows of speech (``--wav`` four times, or synthetic
speech from ``--seed`` .. ``--seed`` + 3) are cut over dp by row and over
tp in time; rank 0 holds the gathered round trip against the one-device
MelCepstralVocoder.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch

from diffsptk_tpu_torch.models import MelCepstralVocoder
from diffsptk_tpu_torch.parallel.ranks import spawn_ranks
from torch_common import parser, rank_count, speech

ROWS = 4
KW = dict(frame_length=400, frame_period=80, fft_length=512, cep_order=24,
          alpha=0.42, n_iter=4)


def worker(rank: int, world: int, device: str, args, mesh_shape):
    from diffsptk_tpu_torch.parallel import (ShardedMelCepstralVocoder,
                                             make_mesh, shard, unshard)

    mesh = make_mesh(mesh_shape, device_type=device)
    dev = torch.device(device, rank) if device == "cuda" else "cpu"
    x, _ = speech(args, dev, rows=ROWS)
    T = x.shape[-1] - x.shape[-1] % (80 * mesh_shape[1])
    x = x[:, :T].contiguous()
    place = dict(device=dev, dtype=torch.float32)
    with torch.no_grad():
        y = unshard(ShardedMelCepstralVocoder(mesh, **KW, **place)
                    .analysis_synthesis(shard(x, mesh)), mesh)
        if rank:
            return None
        want = MelCepstralVocoder(**KW, **place).analysis_synthesis(x)
    return float((y - want).abs().max() / want.abs().max())


def main(argv=None) -> float:
    ap = parser(__doc__)
    ap.add_argument("--ranks", type=int, default=None)
    ap.add_argument("--mesh", type=int, nargs=2, default=None,
                    metavar=("DP", "TP"),
                    help="mesh shape (default: 1 x ranks)")
    args = ap.parse_args(argv)
    ranks, device = rank_count(args)
    mesh_shape = tuple(args.mesh) if args.mesh else (1, ranks)
    err = spawn_ranks(worker, ranks, device, args, mesh_shape)
    print(f"mesh ({mesh_shape[0]} dp x {mesh_shape[1]} tp, {ranks} {device} "
          f"ranks): max relative deviation from the one-device vocoder = "
          f"{err:.2e}")
    return err


if __name__ == "__main__":
    main()
