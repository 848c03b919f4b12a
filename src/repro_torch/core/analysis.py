"""Paper §3.6 — asymptotic runtime models for Procedures 2, 3 and 5.

Implements the closed-form run-time, speedup and efficiency expressions and
the speculative-wins crossover bound (equation 1):

    T₂        = M · d_µ · (t_e + t_c)
    T₃(P)     = (M/P) · d_µ · (t_e + t_c) + t_i + t_s(M)
    T₅(P)     = (M·p/P) · (t_e + log₂(d_µ)·t_c) + t_i + t_s(M)
    S_k(P)    = T₂ / T_k(P)
    E_k(P)    = S_k(P) / P
    speculative beats data decomposition  ⇔  p < 2·d_µ / (1 + log₂ d_µ)

with t_s(M) = σ·M + γ (shared-memory transmission), t_i indexing overhead.
Host-side numpy, as in the JAX package's ``core/analysis.py``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Machine/workload constants of §3.6."""

    t_e: float = 1.0          # node attribute-vs-threshold evaluation time
    t_c: float = 1.0          # class-vs-⊥ comparison time
    t_i: float = 0.0          # per-processor dataset-indexing time
    sigma: float = 0.0        # per-record shared-memory transmission slope
    gamma: float = 0.0        # transmission intercept

    @property
    def t_n(self) -> float:
        """Node evaluation time t_n = t_e + t_c."""
        return self.t_e + self.t_c

    def t_s(self, m: float) -> float:
        return self.sigma * m + self.gamma


def t2_serial(m: float, d_mu: float, cm: CostModel = CostModel()) -> float:
    return m * d_mu * cm.t_n


def t3_data_parallel(m: float, d_mu: float, p_total: float, cm: CostModel = CostModel()) -> float:
    return (m / p_total) * d_mu * cm.t_n + cm.t_i + cm.t_s(m)


def t5_speculative(
    m: float, d_mu: float, p_total: float, p_group: float, cm: CostModel = CostModel()
) -> float:
    return (m * p_group / p_total) * (cm.t_e + math.log2(d_mu) * cm.t_c) + cm.t_i + cm.t_s(m)


def s3_speedup(m, d_mu, p_total, cm: CostModel = CostModel()):
    return t2_serial(m, d_mu, cm) / t3_data_parallel(m, d_mu, p_total, cm)


def s5_speedup(m, d_mu, p_total, p_group, cm: CostModel = CostModel()):
    return t2_serial(m, d_mu, cm) / t5_speculative(m, d_mu, p_total, p_group, cm)


def e3_efficiency(m, d_mu, p_total, cm: CostModel = CostModel()):
    return s3_speedup(m, d_mu, p_total, cm) / p_total


def e5_efficiency(m, d_mu, p_total, p_group, cm: CostModel = CostModel()):
    return s5_speedup(m, d_mu, p_total, p_group, cm) / p_total


def crossover_group_size(d_mu: float) -> float:
    """Equation (1): speculative wins iff p_group < 2·d_µ/(1 + log₂ d_µ).

    (Derived under t_e ≈ t_c; the paper notes the slope is ≈ 1/3 for
    practical d_µ, so only shallow trees or small groups benefit under the
    *independent-processor* model — the SIMD experiments then show the model's
    assumptions are what break on real hardware.)
    """
    if d_mu <= 1:
        return 2.0 * d_mu
    return 2.0 * d_mu / (1.0 + math.log2(d_mu))


def speculative_wins(d_mu: float, p_group: float) -> bool:
    return p_group < crossover_group_size(d_mu)


def mean_traversal_depth(depths: np.ndarray) -> float:
    """d_µ estimated from observed per-record leaf depths (paper: measured on
    a significant sample such as the training set)."""
    return float(np.asarray(depths).mean())


def speculation_waste_ratio(n_nodes: float, d_mu: float) -> float:
    """§3.6 speculative waste: node evaluations per record, all-N vs d_µ.

    Procedure 5 evaluates every one of the ``N`` nodes for each record where
    the divergent descent touches only ``d_µ`` on average — the ratio
    ``N / d_µ`` is the work multiplier speculation pays for its shallower
    critical path.  Measured d_µ (from the traversal profiler) makes this
    the *observed* waste rather than the geometry-prior estimate.
    """
    return float(n_nodes) / max(float(d_mu), 1.0)


def level_active_fractions(depths: np.ndarray, max_depth: int) -> np.ndarray:
    """Fraction of records still descending when entering each round.

    ``out[l] = mean(depth > l)`` for ``l in range(max_depth)`` — the
    active-lane occupancy the paper's SIMD analysis charges idle processors
    for at every level below a record's exit depth.
    """
    depths = np.asarray(depths)
    return np.array(
        [float((depths > l).mean()) for l in range(int(max_depth))], np.float64
    )


def observed_depths(enc, records) -> np.ndarray:
    """Per-record traversal depth under the branchless descent (host)."""
    from repro_torch.core.tree import BOTTOM

    records = np.asarray(records)
    m = records.shape[0]
    out = np.zeros((m,), np.int64)
    for r in range(m):
        i, d = 0, 0
        while enc.class_val[i] == BOTTOM:
            i = int(enc.child[i]) + int(records[r, enc.attr_idx[i]] > enc.threshold[i])
            d += 1
        out[r] = d
    return out
