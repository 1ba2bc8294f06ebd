"""The JAX package's sampling engines on a simulated (4, 2) mesh, in a
process of their own, for ``tests/test_torch_sharding_sampling.py``.

    python tests/torch_dist_jax.py OUT_DIR SPEC_JSON

SPEC_JSON: {"corpus": ..., "test": ..., "runs": [{"name": ..., "cfg": ...,
"steps": S, "free_steps": F}, ...]}.  For each run the engine (Gibbs or
hybrid by the config's ``inference_mode``) takes S steps on
``make_mesh(shape=(4, 2))`` and writes ``OUT_DIR/model-<name>`` (its model
file) and ``OUT_DIR/<name>.npz`` (its state, n_kv and chains, whole),
then F more steps; ``OUT_DIR/results.json`` holds each run's joint
likelihood after S steps (Gibbs, at its alpha and beta and at 0.3 / 0.02)
and its held-out perplexity after S + F.

A process of its own: it runs with JAX's persistent compilation cache
off, because an executable with cross-device collectives loaded from that
cache can stall XLA:CPU's collective rendezvous past its timeout, which
aborts the process; and the tests' process stays clear of it.
"""

import json
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_compilation_cache", False)

import numpy as np  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from pylda_tpu.corpus.synthetic import synthetic_corpus  # noqa: E402
from pylda_tpu.models import Hybrid, MonteCarlo  # noqa: E402
from pylda_tpu.parallel.mesh import make_mesh  # noqa: E402
from pylda_tpu.utils.config import LDAConfig  # noqa: E402


def main(argv) -> int:
    out_dir, spec = argv[0], json.loads(argv[1])
    train, beta, _ = synthetic_corpus(**spec["corpus"])
    test = synthetic_corpus(beta=beta, **spec["test"])[0]
    results = {}
    for run in spec["runs"]:
        cfg = LDAConfig(**run["cfg"])
        gibbs = cfg.inference_mode == "gibbs"
        eng = (MonteCarlo if gibbs else Hybrid)(cfg)
        eng.initialize(train, mesh=make_mesh(shape=(4, 2)))
        for _ in range(run["steps"]):
            eng.learning()
        name = run["name"]
        eng.save(os.path.join(out_dir, f"model-{name}"))
        st = eng.state
        blobs = {k: np.asarray(getattr(st, k))
                 for k in ("lam", "alpha", "eta", "step")}
        res = {}
        if gibbs:
            blobs["n_kv"] = np.asarray(eng._n_kv)
            for i, (z, n) in enumerate(zip(eng._z, eng._ndk)):
                blobs[f"z_{i}"], blobs[f"ndk_{i}"] = np.asarray(z), np.asarray(n)
            res["ll0"] = eng.compute_likelihood()
            res["ll0_scalars"] = eng.compute_likelihood(0.3, 0.02)
        else:
            for i, z in enumerate(eng._z_hyb):
                blobs[f"zh_{i}"] = np.asarray(z)
        np.savez(os.path.join(out_dir, f"{name}.npz"), **blobs)
        for _ in range(run["free_steps"]):
            eng.learning()
        res["perplexity"] = eng.perplexity(test)
        results[name] = res
    with open(os.path.join(out_dir, "results.json"), "w") as f:
        json.dump(results, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
