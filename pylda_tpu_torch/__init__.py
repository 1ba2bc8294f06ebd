"""pylda_tpu_torch — the PyTorch/CUDA port of pylda_tpu.

Latent Dirichlet Allocation in PyTorch for an NVIDIA H100.  The JAX
package ``pylda_tpu`` beside it is the reference this package is held
against; nothing here imports it or JAX.  Plain tensor code is PyTorch,
and every Pallas kernel of ``pylda_tpu`` on the ported path is a CUDA
kernel written by hand for Hopper (``pylda_tpu_torch/csrc``), built with
``nvcc`` on first use and loaded with ``ctypes``.  Entry points run on the
CUDA card unless the caller passes ``device="cpu"``, where each kernel's
plain PyTorch version runs instead.

Ported so far: batch VB (``VariationalBayes``) on both layouts — the
dense route (V <= ``dense_vocab_threshold``: the dense gamma fixed point
and sufficient statistics) and the large-vocabulary route (ragged gamma
fixed point + dense sufficient statistics) — with ``initialize``,
``learning``, ``learning_many``, ``inference``, ``perplexity``,
``point_estimate_perplexity`` and ``export_beta``; the ``model-<N>`` files
(``save``/``load``, npz, readable by either package); the bundled corpus
and input-directory loading (``corpus.datasets``); and the reference's
CLIs, ``python -m pylda_tpu_torch.cli.train`` / ``.test`` / ``.infer``.
"""

from pylda_tpu_torch.utils.config import LDAConfig
from pylda_tpu_torch.corpus.vocabulary import Vocabulary
from pylda_tpu_torch.corpus.corpus import Corpus
from pylda_tpu_torch.models import (
    Inferencer,
    LDAState,
    VariationalBayes,
    make_engine,
    state_from_numpy,
)

__version__ = "0.1.0"

__all__ = [
    "__version__",
    "LDAConfig",
    "Vocabulary",
    "Corpus",
    "Inferencer",
    "LDAState",
    "VariationalBayes",
    "make_engine",
    "state_from_numpy",
]
