from pylda_tpu_torch.models.base import (
    Inferencer,
    LDAState,
    state_from_numpy,
)
from pylda_tpu_torch.models.gibbs import MonteCarlo
from pylda_tpu_torch.models.hybrid import Hybrid
from pylda_tpu_torch.models.svi import StochasticVariationalBayes
from pylda_tpu_torch.models.vb import VariationalBayes

# --inference_mode → engine class.
ENGINES = {
    "vb": VariationalBayes,
    "gibbs": MonteCarlo,
    "hybrid": Hybrid,
    "svi": StochasticVariationalBayes,
}


def make_engine(config, device=None):
    return ENGINES[config.inference_mode](config, device=device)


__all__ = [
    "Inferencer",
    "LDAState",
    "VariationalBayes",
    "MonteCarlo",
    "Hybrid",
    "StochasticVariationalBayes",
    "ENGINES",
    "make_engine",
    "state_from_numpy",
]
