"""Online inference launcher — the serving surface.

    python -m pylda_tpu_torch.cli.infer --model=<run-dir>/model-<N> \\
        [--input=docs.txt] [--output=mix.tsv] [--full] [--device=cpu]

Counterpart of ``pylda_tpu.cli.infer`` (``pylda-infer``): load a trained
``model-<N>`` once, then map new documents (stdin or a file, one per line)
to topic mixtures with the global state frozen — the same E-step as
``inference()``, batched per ``--batch_size`` documents.  Output per
document (TSV): the top ``--top_topics`` topics as ``topic:probability``
pairs, or the full theta row with ``--full``.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m pylda_tpu_torch.cli.infer",
        description="Map new documents to LDA topic mixtures",
    )
    p.add_argument("--model", required=True, help="path to a model-<N> file")
    p.add_argument("--input", default="-",
                   help="file of documents, one per line ('-' = stdin)")
    p.add_argument("--output", default="-",
                   help="output file ('-' = stdout)")
    p.add_argument("--top_topics", type=int, default=5)
    p.add_argument("--full", action="store_true",
                   help="emit the full theta row instead of top topics")
    p.add_argument("--batch_size", type=int, default=1024,
                   help="documents per device batch")
    p.add_argument("--device", default=None,
                   help="torch device: the CUDA card by default; 'cpu' "
                        "runs the plain PyTorch versions of the kernels")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    from pylda_tpu_torch.corpus.corpus import Corpus
    from pylda_tpu_torch.models import Inferencer

    engine = Inferencer.load(args.model, device=args.device)
    vocab = engine._vocab

    fin = sys.stdin if args.input == "-" else open(args.input, "r",
                                                  encoding="utf-8")
    fout = sys.stdout if args.output == "-" else open(args.output, "w",
                                                      encoding="utf-8")
    try:
        pending: List[str] = []

        def flush() -> None:
            if not pending:
                return
            _, gamma = engine.inference(Corpus.from_lines(pending, vocab))
            theta = gamma / gamma.sum(axis=1, keepdims=True)
            for row in theta:
                if args.full:
                    fout.write("\t".join(f"{x:.6g}" for x in row) + "\n")
                else:
                    top = np.argsort(-row)[: args.top_topics]
                    fout.write(
                        "\t".join(f"{k}:{row[k]:.4f}" for k in top) + "\n"
                    )
            fout.flush()
            pending.clear()

        for line in fin:
            pending.append(line.rstrip("\n"))
            if len(pending) >= args.batch_size:
                flush()
        flush()
    finally:
        if fin is not sys.stdin:
            fin.close()
        if fout is not sys.stdout:
            fout.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
