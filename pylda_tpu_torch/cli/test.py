"""Held-out evaluation launcher — the reference's ``launch_test.py``.

    python -m pylda_tpu_torch.cli.test --model=<run-dir>/model-<N> \\
        --input_directory=DIR [--device=cpu]

Counterpart of ``pylda_tpu.cli.test`` (``pylda-test``): restore a
``model-<N>`` file (written by either package), load the test corpus from
--input_directory (test.dat, or doc.dat with --use_train_split or when
test.dat is missing) against the model's own vocabulary, run
``inference()`` with the global state frozen, write per-document gamma,
and log the held-out log likelihood and per-word perplexity (and, with
``--coherence``, the model's UMass topic coherence on the evaluated
corpus).
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np

from pylda_tpu_torch.corpus.corpus import Corpus
from pylda_tpu_torch.corpus.datasets import load_input_directory
from pylda_tpu_torch.utils.metrics import MetricsLogger


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m pylda_tpu_torch.cli.test",
        description="Held-out evaluation of a trained LDA snapshot",
    )
    p.add_argument("--model", required=True, help="path to a model-<N> file")
    p.add_argument("--input_directory", required=True)
    p.add_argument("--output_file", default=None,
                   help="write per-doc gamma here (default: gamma-<N> next "
                        "to the model)")
    p.add_argument("--use_train_split", action="store_true",
                   help="evaluate doc.dat instead of test.dat")
    p.add_argument("--coherence", action="store_true",
                   help="also report per-topic UMass coherence of the "
                        "model's top words, scored on the evaluated "
                        "corpus (utils/coherence.py)")
    p.add_argument("--coherence_top_n", type=int, default=10)
    p.add_argument("--point_estimate", action="store_true",
                   help="also report the convention-neutral "
                        "point-estimate perplexity (theta_hat @ beta_hat)")
    p.add_argument("--device", default=None,
                   help="torch device: the CUDA card by default; 'cpu' "
                        "runs the plain PyTorch versions of the kernels")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    from pylda_tpu_torch.models import Inferencer

    engine = Inferencer.load(args.model, device=args.device)
    train, test = _load_with_vocab(args.input_directory, engine._vocab)
    corpus = train if (args.use_train_split or test is None) else test
    if corpus is None:
        raise SystemExit(
            f"no evaluable split in {args.input_directory}: "
            + ("doc.dat missing (needed for --use_train_split)"
               if args.use_train_split else "doc.dat and test.dat missing")
        )

    ll, gamma = engine.inference(corpus)
    perplexity = float(np.exp(-ll / max(1, corpus.num_tokens)))

    out = args.output_file
    if out is None:
        n = os.path.basename(args.model).rsplit("-", 1)[-1]
        out = os.path.join(os.path.dirname(args.model) or ".", f"gamma-{n}")
    np.savetxt(out, gamma, fmt="%.8g", delimiter="\t")

    extra = {}
    if args.point_estimate:
        extra["point_estimate_perplexity"] = round(
            engine.point_estimate_perplexity(corpus), 4
        )
    metrics = MetricsLogger()
    metrics.log(
        event="heldout",
        model=args.model,
        documents=corpus.num_docs,
        tokens=corpus.num_tokens,
        log_likelihood=ll,
        per_word_perplexity=round(perplexity, 4),
        gamma_file=out,
        **extra,
    )
    if args.coherence:
        from pylda_tpu_torch.utils.coherence import engine_coherence

        coh = engine_coherence(engine, corpus, top_n=args.coherence_top_n)
        metrics.log(
            event="coherence",
            mean_umass=round(coh["mean"], 4),
            top_n=coh["top_n"],
            per_topic=[round(c, 3) for c in coh["per_topic"]],
        )
    return 0


def _load_with_vocab(input_directory: str, vocab):
    """(train, test) parsed against the model's OWN vocabulary (type ids
    must match training); doc.dat or train.dat as the training loader
    accepts."""
    train = None
    for name in ("doc.dat", "train.dat"):
        doc_path = os.path.join(input_directory, name)
        if os.path.exists(doc_path):
            train = Corpus.from_file(doc_path, vocab)
            break
    test_path = os.path.join(input_directory, "test.dat")
    test = (
        Corpus.from_file(test_path, vocab)
        if os.path.exists(test_path)
        else None
    )
    if train is None and test is None:
        load_input_directory(input_directory)  # raises the loader's error
    return train, test


if __name__ == "__main__":
    raise SystemExit(main())
