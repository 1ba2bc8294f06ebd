"""Counts the work of the dense sufficient-statistics kernel's column walk
at the two flagship shapes: no device needed, the counts decide it.

    PYTHONPATH=. python scripts/torch_sstats_walk_steps.py [--device cpu]

For the counts the engine plans from the synthetic corpus (K=100,
D=4096, mean document length 120, seed 0) at V=10,000 (the ragged
route's [4096, 10240] chunk) and V=4096 (the dense batch), in the
kernel's geometry (``ops/sstats.py``: 64-column tiles, 32-row chunks,
warp w owning columns 8w..8w+7, four lanes a column): the nonzeros; the
warp-steps of the column walk (each warp takes as many steps in a chunk
as its busiest column has nonzeros); the share of 4-lane groups busy in
those steps; the mean steps of a CTA's busiest warp a chunk (the walk's
critical path between two barriers); and the mean rows a chunk touches
in a tile (the expEtheta rows staged).
"""

from __future__ import annotations

import argparse

import torch

from pylda_tpu_torch.corpus.synthetic import synthetic_corpus
from pylda_tpu_torch.models import VariationalBayes
from pylda_tpu_torch.ops import sstats as sstats_mod
from pylda_tpu_torch.utils.config import LDAConfig

K, D, MEAN_LEN = 100, 4096, 120.0


def walk_counts(counts: torch.Tensor) -> dict:
    rows, tile = sstats_mod.CHUNK_ROWS, sstats_mod.TILE_V
    nz = counts != 0
    Dc, Vc = nz.shape
    tiles = -(-Vc // tile)
    chunks = -(-Dc // rows)
    nzp = torch.zeros((chunks * rows, tiles * tile), dtype=torch.bool,
                      device=nz.device)
    nzp[:Dc, :Vc] = nz
    per_col = nzp.reshape(chunks, rows, tiles * tile).sum(1)
    warp_steps = per_col.reshape(chunks, tiles, 8, 8).amax(-1)
    touched = nzp.reshape(chunks, rows, tiles, tile).any(-1).sum(1)
    n = int(nz.sum())
    steps = int(warp_steps.sum())
    return {"nonzeros": n, "warp_steps": steps,
            "groups_busy": n / (8 * steps),
            "cta_steps_per_chunk": float(warp_steps.amax(-1).float().mean()),
            "touched_rows_per_chunk": float(touched.float().mean())}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    cfg = LDAConfig(number_of_topics=K, seed=0)
    for label, V in (("ragged flagship chunk", 10_000),
                     ("dense flagship batch", 4096)):
        corpus, _, _ = synthetic_corpus(num_docs=D, num_topics=K, num_types=V,
                                        mean_doc_length=MEAN_LEN, seed=0)
        eng = VariationalBayes(cfg, device=args.device)
        eng.initialize(corpus)
        if eng._sstats_plan is not None:
            counts = eng._sstats_plan.chunks[0][0]
        else:
            counts = eng._batches[0].counts
        got = walk_counts(counts)
        print(f"{label} {tuple(counts.shape)}: " + ", ".join(
            f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in got.items()))


if __name__ == "__main__":
    main()
