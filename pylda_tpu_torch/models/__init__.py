from pylda_tpu_torch.models.base import Inferencer, LDAState, state_from_numpy
from pylda_tpu_torch.models.svi import StochasticVariationalBayes
from pylda_tpu_torch.models.vb import VariationalBayes

# --inference_mode → engine class.
ENGINES = {"vb": VariationalBayes, "svi": StochasticVariationalBayes}

# Engines of the JAX package still to port, with their ROADMAP items.
_NOT_PORTED = {
    "gibbs": "ROADMAP.md Queue 1 item 11",
    "hybrid": "ROADMAP.md Queue 1 item 11",
}


def make_engine(config, device=None):
    mode = config.inference_mode
    if mode in _NOT_PORTED:
        raise NotImplementedError(
            f"inference_mode={mode!r} is not ported yet ({_NOT_PORTED[mode]})"
        )
    return ENGINES[mode](config, device=device)


__all__ = [
    "Inferencer",
    "LDAState",
    "VariationalBayes",
    "StochasticVariationalBayes",
    "ENGINES",
    "make_engine",
    "state_from_numpy",
]
