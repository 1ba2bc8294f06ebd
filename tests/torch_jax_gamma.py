"""The JAX package's bf16 gamma fixed point on the CPU, as a float32
reference beside the port's plain version.

``test_torch_kernels_gpu.py`` imports it (its conftest has set JAX to the
CPU); a script that must not import JAX runs it in a process of its own:

    python tests/torch_jax_gamma.py <inputs.npz> <gamma.npz> [..]

(more pairs of the two files run in the same process), with
``inputs.npz`` holding ``counts`` [D, V] (dense) or ``ids`` and
``cnts`` [D, T] (ragged), ``gamma0`` [D, K], ``eeb`` [K, V], ``alpha``
[K], ``segments`` (row counts, ragged only), ``inner_iterations``,
``convergence_threshold`` and ``stall_patience``; it writes ``gamma``.
Dense rows go through ``pylda_tpu/ops/estep.py::estep_dense``, ragged
rows through ``estep_ragged_gamma`` on each segment's rows alone (what a
segment is: the chunk the JAX engine runs as one call), both with
``compute_dtype="bfloat16"``.
"""

import os
import sys

import numpy as np

BF16 = "bfloat16"


def jax_gamma(gamma0, eeb, alpha, kw, counts=None, ids=None, cnts=None,
              segments=None):
    """The JAX package's bf16 gamma (numpy float32) for dense ``counts`` or
    ragged ``ids`` / ``cnts`` (split into ``segments``, each run alone)."""
    import jax.numpy as jnp

    from pylda_tpu.ops.estep import estep_dense, estep_ragged_gamma

    f32 = [jnp.asarray(np.asarray(x, np.float32)) for x in
           (gamma0, eeb, alpha)]
    if counts is not None:
        g, _, _, _ = estep_dense(jnp.asarray(np.asarray(counts, np.float32)),
                                 *f32, **kw, compute_dtype=BF16)
        return np.asarray(g, np.float32)
    out, r0 = [], 0
    for n in segments or (len(ids),):
        part = slice(r0, r0 + n)
        g, _ = estep_ragged_gamma(
            jnp.asarray(np.asarray(ids[part], np.int32)),
            jnp.asarray(np.asarray(cnts[part], np.float32)), f32[0][part],
            f32[1], f32[2], **kw, compute_dtype=BF16)
        out.append(np.asarray(g, np.float32))
        r0 += n
    return np.concatenate(out)


def main(argv) -> int:
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    for src, dst in zip(argv[::2], argv[1::2]):
        z = np.load(src)
        kw = {k: z[k].item() for k in ("inner_iterations",
                                       "convergence_threshold",
                                       "stall_patience")}
        rows = ({"counts": z["counts"]} if "counts" in z
                else {"ids": z["ids"], "cnts": z["cnts"],
                      "segments": [int(n) for n in z["segments"]]})
        np.savez(dst, gamma=jax_gamma(z["gamma0"], z["eeb"], z["alpha"],
                                      kw, **rows))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    raise SystemExit(main(sys.argv[1:]))
