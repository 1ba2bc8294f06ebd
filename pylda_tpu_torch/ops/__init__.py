from pylda_tpu_torch.ops.dirichlet import (
    dirichlet_expectation,
    exp_dirichlet_expectation,
    theta_elbo,
    beta_elbo,
)
from pylda_tpu_torch.ops.estep import (
    estep_dense,
    estep_dense_sstats,
    estep_ragged_gamma,
)
from pylda_tpu_torch.ops.hyper import newton_dirichlet_mle
from pylda_tpu_torch.ops.ragged import ragged_gamma
from pylda_tpu_torch.ops.sstats import dense_sstats

__all__ = [
    "dirichlet_expectation",
    "exp_dirichlet_expectation",
    "theta_elbo",
    "beta_elbo",
    "estep_dense",
    "estep_dense_sstats",
    "estep_ragged_gamma",
    "newton_dirichlet_mle",
    "ragged_gamma",
    "dense_sstats",
]
