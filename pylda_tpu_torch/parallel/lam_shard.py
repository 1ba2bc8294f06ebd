"""Lambda split over the mesh's model axis (``--shard_vocab``,
``--shard_topics``).

The JAX package places lambda ``P(None, "model")`` (vocab) or
``P("model", None)`` (topics) and lets GSPMD partition the step; a Pallas
call given a sharded operand gets it whole.  Here each rank of a model
group holds its block of lambda (``mesh.block_bounds`` over V or K, in
model order) and the VB family calls this module where a step needs more
than its block:

- expElogbeta needs each topic's row sum: under ``shard_vocab`` the
  partial row sums are all-reduced over the model group (a K-vector);
  under ``shard_topics`` a rank's rows are whole;
- the gamma fixed point reads every topic of every word: the rank's block
  of expElogbeta is all-gathered over the model group, once an E-step,
  and every rank of a model group then runs the same fixed point for its
  documents (``gather``);
- the sufficient statistics are computed for the rank's block only (the
  kernels' and plain versions' ``topic_range`` / ``vocab_range``), so
  lambda's update is local;
- the topic side of the bound and the Newton eta input sum over K or V:
  partial sums over the model group (``beta_elbo``, ``elog_lambda_sum``).

The sampling engines keep their topic-word tables in the same blocks
(Gibbs: lambda and the count table n_kv; hybrid: lambda).  A rebuild
counts each rank's tokens into its block only (``ranges``, the
``count_table`` form of ``ops/sampling.py``), and a step gathers the
whole table once, contiguous (``gather(..., contiguous=True)``), before
it samples: the sampler, the factor and every reduction over the table
then see the one-process bits.

alpha [K] and eta [V] stay whole on every rank, where the JAX package
splits them over "model" too (ROADMAP.md Queue 3: a divergence kept on
purpose, they are K and V floats).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch.special import gammaln

from pylda_tpu_torch.ops.dirichlet import (
    beta_elbo,
    digamma_fast,
    dirichlet_expectation,
    exp_dirichlet_expectation_fast,
    gammaln_fast,
)
from pylda_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather_blocks,
    all_reduce_sum,
    block_bounds,
)

VOCAB, TOPICS = "vocab", "topics"


@dataclasses.dataclass(frozen=True)
class LamShard:
    """This rank's block of a [K, V] lambda: columns (``mode`` "vocab")
    or rows ("topics") ``bounds`` of the model group's split."""

    mode: str
    mesh: Mesh
    K: int
    V: int

    @property
    def axis(self) -> int:
        return 1 if self.mode == VOCAB else 0

    @property
    def total(self) -> int:
        return self.V if self.mode == VOCAB else self.K

    @property
    def bounds(self) -> Tuple[int, int]:
        return block_bounds(self.total, self.mesh.model_index,
                            self.mesh.model)

    @property
    def vocab_range(self) -> Optional[Tuple[int, int]]:
        return self.bounds if self.mode == VOCAB else None

    @property
    def topic_range(self) -> Optional[Tuple[int, int]]:
        return self.bounds if self.mode == TOPICS else None

    @property
    def ranges(self) -> dict:
        """``topic_range`` and ``vocab_range`` of this rank's block: the
        keyword arguments of a count or sufficient-statistics call that
        fills the block alone."""
        return {"topic_range": self.topic_range,
                "vocab_range": self.vocab_range}

    def take(self, full):
        """This rank's block of a [K, V] array or tensor (lambda, or a
        count table n_kv; a view)."""
        lo, hi = self.bounds
        return full[:, lo:hi] if self.mode == VOCAB else full[lo:hi]

    def eta_cols(self, eta: torch.Tensor) -> torch.Tensor:
        """The entries of eta [V] this rank's columns take."""
        lo, hi = self.bounds
        return eta[lo:hi] if self.mode == VOCAB else eta

    def gather(self, local: torch.Tensor, contiguous: bool = False
               ) -> torch.Tensor:
        """The whole [K, V] tensor from each rank's block (collective over
        the model group; a transposed view under ``shard_vocab`` unless
        ``contiguous``)."""
        return all_gather_blocks(local, self.total, self.mesh, self.axis,
                                 contiguous)

    def row_sums(self, lam: torch.Tensor) -> torch.Tensor:
        """[K_block, 1]: each topic's sum over all V (all-reduced over the
        model group under ``shard_vocab``)."""
        s = lam.sum(dim=-1, keepdim=True)
        if self.mode == VOCAB:
            all_reduce_sum(s, self.mesh, "model")
        return s

    def exp_elog_beta(self, lam: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``exp_dirichlet_expectation_fast`` of the
        whole lambda."""
        return exp_dirichlet_expectation_fast(lam, self.row_sums(lam))

    def elog_lambda_sum(self, lam: torch.Tensor) -> torch.Tensor:
        """[V]: E[log beta] summed over the K topics, whole on every rank
        (the Newton eta update's input): partial sums all-reduced over the
        model group (topics), or the column block's gathered (vocab)."""
        part = dirichlet_expectation(lam, self.row_sums(lam)).sum(dim=0)
        if self.mode == TOPICS:
            return all_reduce_sum(part, self.mesh, "model")
        return self.gather(part[None, :])[0]

    def beta_elbo(self, lam: torch.Tensor, eta: torch.Tensor
                  ) -> torch.Tensor:
        """``ops.dirichlet.beta_elbo`` of the whole lambda: each rank's
        terms summed over the model group, the terms of whole rows once."""
        if self.mode == TOPICS:
            return all_reduce_sum(beta_elbo(lam, eta).reshape(1), self.mesh,
                                  "model")[0]
        s = self.row_sums(lam)
        elog = digamma_fast(lam) - digamma_fast(s)
        part = (((self.eta_cols(eta)[None, :] - lam) * elog).sum()
                + gammaln_fast(lam).sum()).reshape(1)
        all_reduce_sum(part, self.mesh, "model")
        return (part[0] - gammaln_fast(s[:, 0]).sum()
                + self.K * (gammaln(eta.sum()) - gammaln(eta).sum()))


def shard_of(shard_vocab: bool, shard_topics: bool, mesh: Optional[Mesh],
             K: int, V: int) -> Optional[LamShard]:
    """The rank's ``LamShard`` under a mesh with a model axis above 1 and
    one of the flags (``LDAConfig.validate`` refuses both); None
    otherwise (lambda whole on every rank, and a model group of M > 1 a
    set of replicas)."""
    if mesh is None or mesh.model == 1 or not (shard_vocab or shard_topics):
        return None
    return LamShard(VOCAB if shard_vocab else TOPICS, mesh, K, V)
