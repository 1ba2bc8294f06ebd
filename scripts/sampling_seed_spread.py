"""How the sampling engines of both packages spread over seeds (CPU).

    PYTHONPATH=. python scripts/sampling_seed_spread.py [cli|mixing|gate|rebuild ...]

The port's Gibbs and hybrid engines draw other random streams than the
JAX package's, so their chains agree in distribution, not draw for draw.
Each study prints what the tests and PERF.md cite:

- ``cli``: the final held-out perplexity of ``pylda-train`` and of
  ``python -m pylda_tpu_torch.cli.train --device=cpu`` on
  ``data/de-news-tiny`` (K=10, 10 iterations, snapshots every 5, 5 kept
  sweeps after 3 burn-in) at seeds 0-19, per mode, sorted: the band
  ``tests/test_torch_cli.py`` holds the port's CLI to;
- ``mixing``: Gibbs's joint LL over sweeps 1-20 on the 80-document
  corpus of ``tests/test_sampling_engines.py`` at seeds 0-11, B = 8 and
  B = 1, both packages: the difference of the means in standard errors
  of that difference;
- ``gate``: hybrid and Gibbs point-estimate perplexity on held-out
  documents of the same beta, at K=5 (V=150, 120 documents, seeds 0-7,
  both packages) and at K=10 (V=500, 300 documents, seeds 0-4, the port),
  as ``tests/test_torch_sampling_engines.py`` builds them;
- ``rebuild``: Gibbs's LL after 60 sweeps at ``gibbs_rebuild_interval``
  1 and 3 on that corpus, seeds 0-47, both packages: the sorted values,
  and the seeds whose chain is trapped in a local mode (LL below
  ``TRAPPED_LL``; the two modes leave -14,500..-14,000 empty).

No chip is needed; nothing here is a device number.
"""

from __future__ import annotations

import contextlib
import glob
import io
import json
import os
import sys
import tempfile

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from pylda_tpu.cli.train import main as jax_train  # noqa: E402
from pylda_tpu.corpus.synthetic import synthetic_corpus as jax_synthetic  # noqa: E402
from pylda_tpu.models import Hybrid as JaxHybrid  # noqa: E402
from pylda_tpu.models import MonteCarlo as JaxMonteCarlo  # noqa: E402
from pylda_tpu.utils.config import LDAConfig as JaxConfig  # noqa: E402
from pylda_tpu_torch.cli.train import main as port_train  # noqa: E402
from pylda_tpu_torch.corpus.synthetic import synthetic_corpus  # noqa: E402
from pylda_tpu_torch.models import Hybrid, MonteCarlo  # noqa: E402
from pylda_tpu_torch.utils.config import LDAConfig  # noqa: E402

CLI_ARGS = ["--number_of_topics=10", "--training_iterations=10",
            "--snapshot_interval=5", "--number_of_samples=5",
            "--burn_in_sweeps=3"]
SMALL = dict(num_docs=80, num_topics=5, num_types=150, mean_doc_length=50,
             seed=3)
SMALL_CFG = dict(number_of_topics=5, inference_mode="gibbs", alpha_alpha=0.2,
                 alpha_beta=0.05, doc_pad_multiple=8,
                 bucket_sizes=(64, 128, 256))
# Sweep-60 LL below this: a chain trapped in a local mode (``rebuild``).
TRAPPED_LL = -14200.0
ENGINES = {"gibbs": (MonteCarlo, JaxMonteCarlo), "hybrid": (Hybrid, JaxHybrid)}


def engine(package: str, mode: str, corpus, **cfg):
    port, jax_cls = ENGINES[mode]
    if package == "port":
        eng = port(LDAConfig(inference_mode=mode, **cfg), device="cpu")
    else:
        eng = jax_cls(JaxConfig(inference_mode=mode, **cfg))
    eng.initialize(corpus)
    return eng


def corpora(**kw):
    return {"port": synthetic_corpus(**kw), "jax": jax_synthetic(**kw)}


def cli() -> None:
    for mode in ("gibbs", "hybrid"):
        for name, train, extra in (("jax", jax_train, []),
                                   ("port", port_train, ["--device=cpu"])):
            vals = []
            for seed in range(20):
                with tempfile.TemporaryDirectory() as out, \
                        contextlib.redirect_stdout(io.StringIO()):
                    train(["--input_directory=data/de-news-tiny",
                           f"--output_directory={out}",
                           f"--inference_mode={mode}", f"--seed={seed}",
                           *CLI_ARGS, *extra])
                    (path,) = glob.glob(os.path.join(out, "*", "*",
                                                     "metrics.jsonl"))
                    with open(path) as f:
                        vals.append([json.loads(x) for x in f][-1][
                            "perplexity"])
            print(f"cli {mode} {name}: seeds 0-19 sorted {sorted(vals)}",
                  flush=True)


def mixing() -> None:
    cs = corpora(**SMALL)
    for B in (8, 1):
        lls = {p: np.array([engine(p, "gibbs", cs[p][0], seed=s,
                                   sampler_block_positions=B,
                                   **{k: v for k, v in SMALL_CFG.items()
                                      if k != "inference_mode"}
                                   ).learning_many(20) for s in range(12)])
               for p in ("port", "jax")}
        se = np.sqrt(sum(x.var(0, ddof=1) / 12 for x in lls.values()))
        z = (lls["port"].mean(0) - lls["jax"].mean(0)) / se
        print(f"mixing B={B}: (port - jax) mean LL in standard errors, "
              f"sweeps 1-20: {np.round(z, 2).tolist()}; max |z| "
              f"{np.abs(z).max():.2f}", flush=True)


def gate() -> None:
    for K, V, D, seeds, packages in ((5, 150, 120, 8, ("port", "jax")),
                                     (10, 500, 300, 5, ("port",))):
        kw = dict(num_topics=K, num_types=V, mean_doc_length=60 if K == 5
                  else 80)
        for p in packages:
            mk = synthetic_corpus if p == "port" else jax_synthetic
            train, beta, _ = mk(num_docs=D, seed=5, **kw)
            test, _, _ = mk(num_docs=40 if K == 5 else 60, seed=105,
                            beta=beta, **kw)
            rows = []
            for s in range(seeds):
                pe = {}
                for mode in ("gibbs", "hybrid"):
                    eng = engine(p, mode, train, number_of_topics=K, seed=s,
                                 number_of_samples=5, burn_in_sweeps=3)
                    eng.learning_many(30 if K == 5 else 25)
                    pe[mode] = eng.point_estimate_perplexity(test)
                rows.append((round(pe["gibbs"], 2), round(pe["hybrid"], 2),
                             round(pe["hybrid"] / pe["gibbs"], 3)))
            print(f"gate K={K} {p}: (gibbs, hybrid, ratio) at seeds "
                  f"0-{seeds - 1}: {rows}", flush=True)


def rebuild() -> None:
    cs = corpora(**SMALL)
    cfg = {k: v for k, v in SMALL_CFG.items() if k != "inference_mode"}
    for p in ("port", "jax"):
        for R in (1, 3):
            last = np.array([engine(p, "gibbs", cs[p][0], seed=s,
                                    gibbs_rebuild_interval=R, **cfg
                                    ).learning_many(60)[-1]
                             for s in range(48)])
            trapped = np.flatnonzero(last < TRAPPED_LL).tolist()
            print(f"rebuild {p} R={R}: LL after 60 sweeps at seeds 0-47, "
                  f"sorted {np.sort(last).round(1).tolist()}; trapped "
                  f"{len(trapped)} of 48 (seeds {trapped}); median of the "
                  f"rest {np.median(last[last >= TRAPPED_LL]):.1f}",
                  flush=True)


def main() -> None:
    torch.set_num_threads(2)
    studies = {"cli": cli, "mixing": mixing, "gate": gate,
               "rebuild": rebuild}
    for name in sys.argv[1:] or list(studies):
        studies[name]()


if __name__ == "__main__":
    main()
