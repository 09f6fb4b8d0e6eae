"""Convergence watchdog for SN-Train under unreliable links.

Port of ``repro.core.monitor``.  The SOP recursion is Fejer monotone under
perfect delivery (Lemma 2.1: ``weighted_norm_sq`` never grows along a
sweep), but a partial delivery is not a projection, and at high loss the
iterates can drift or diverge.  ``watch_sweeps`` supervises faulty
training:

  per round (``sweeps_per_round`` sweeps in one ``faulty_sweep`` call):
    track    per-field Fejer norm and relative z-residual (one host read);
    detect   divergence: a field's norm grew past ``divergence_ratio`` (or
             went non-finite) for ``patience`` consecutive rounds;
    retry    the round with fresh fault draws (at most ``max_retries``);
    escalate to one refactorization of every local system
             (``streaming.rebuild_chol``);
    rollback to the entry snapshot (in memory, or an on-disk
             ``checkpoint.save_train`` directory) when even fresh factors
             keep diverging: restore it bitwise and stop.

The host decides which round to run next from the round's norms and
residuals; everything else stays on the device.  The receipt is host-side
numpy, as in the reference, with the same JSON schema.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..checkpoint import restore_train, save_train
from . import faults as faults_mod
from . import sn_train
from .sn_train import SNTrainProblem, SNTrainState, weighted_norm_sq
from .streaming import rebuild_chol


@dataclasses.dataclass(frozen=True)
class WatchdogConfig:
    """Host-side knobs of ``watch_sweeps``."""

    sweeps_per_round: int = 5
    tol: float = 1e-4  # converged: max |dz| / (max |z| + eps) < tol
    divergence_ratio: float = 1.05  # norm growth flagging a round
    patience: int = 2  # consecutive flagged rounds before acting
    max_retries: int = 3  # fresh-draw re-sweeps before escalating
    max_rounds: int = 60


RECEIPT_SCHEMA = "watchdog_receipt/1"


class WatchdogReceipt(NamedTuple):
    """What happened, per field and overall (printed by the launcher)."""

    converged: np.ndarray  # (B,) bool per-field residual < tol
    residual: np.ndarray  # (B,) final relative z-residual per round
    norm: np.ndarray  # (B,) final Fejer norm
    rounds: int  # rounds accepted or retried
    sweeps: int  # total sweeps executed (retried rounds included)
    retries: int  # fresh-draw re-sweeps taken
    refactorized: int  # 0/1: rebuild_chol escalations
    rolled_back: bool  # True: state restored from the snapshot
    diverged: np.ndarray  # (B,) bool fields flagged in the final round

    def to_json(self) -> dict:
        """Machine-readable receipt with a stable schema (plain JSON types,
        per-field arrays as lists, tagged with ``schema``);
        ``receipt_from_json`` is its exact inverse."""
        return {
            "schema": RECEIPT_SCHEMA,
            "converged": [bool(v) for v in np.atleast_1d(self.converged)],
            "residual": [float(v) for v in np.atleast_1d(self.residual)],
            "norm": [float(v) for v in np.atleast_1d(self.norm)],
            "rounds": int(self.rounds),
            "sweeps": int(self.sweeps),
            "retries": int(self.retries),
            "refactorized": int(self.refactorized),
            "rolled_back": bool(self.rolled_back),
            "diverged": [bool(v) for v in np.atleast_1d(self.diverged)],
        }


def receipt_from_json(payload: dict) -> WatchdogReceipt:
    """Rebuild a ``WatchdogReceipt`` from ``WatchdogReceipt.to_json``."""
    schema = payload.get("schema")
    if schema != RECEIPT_SCHEMA:
        raise ValueError(
            f"unknown watchdog receipt schema {schema!r} (expected {RECEIPT_SCHEMA!r})"
        )
    return WatchdogReceipt(
        converged=np.asarray(payload["converged"], bool),
        residual=np.asarray(payload["residual"], float),
        norm=np.asarray(payload["norm"], float),
        rounds=int(payload["rounds"]),
        sweeps=int(payload["sweeps"]),
        retries=int(payload["retries"]),
        refactorized=int(payload["refactorized"]),
        rolled_back=bool(payload["rolled_back"]),
        diverged=np.asarray(payload["diverged"], bool),
    )


def _round_metrics(problem, state_old, state_new) -> torch.Tensor:
    """(2, ...) stack of the Fejer norm of ``state_new`` and the per-field
    relative z-residual, read by the host in one transfer."""
    norm = weighted_norm_sq(problem, state_new)
    num = torch.amax(torch.abs(state_new.z - state_old.z), dim=-1)
    den = torch.amax(torch.abs(state_old.z), dim=-1) + 1e-12
    return torch.stack([norm, num / den])


def _host(metrics: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    m = metrics.cpu().numpy()
    return np.atleast_1d(m[0]), np.atleast_1d(m[1])


def _snapshot(problem, state, directory):
    """The entry snapshot.  In memory, the tensors a later call could
    overwrite in place (the state's, and the factors a refactorization
    replaces) are cloned; on disk, one ``save_train`` at step 0."""
    if directory is None:
        return (
            dataclasses.replace(problem, chol=problem.chol.clone()),
            SNTrainState(z=state.z.clone(), coef=state.coef.clone()),
        )
    save_train(directory, 0, problem, state)
    return None


def _rollback(problem, state, directory, mem):
    if directory is None:
        return mem
    return restore_train(directory, 0, problem, state)


def watch_sweeps(
    problem: SNTrainProblem,
    state: SNTrainState,
    *,
    model: faults_mod.FaultModel | None = None,
    generator: torch.Generator | None = None,
    engine: str = "plan",
    config: WatchdogConfig = WatchdogConfig(),
    snapshot_dir: str | None = None,
) -> tuple[SNTrainProblem, SNTrainState, WatchdogReceipt]:
    """Train to convergence under supervision; see the module docstring.

    model/generator: the fault process to inject and its ``torch.Generator``
    on the problem's device (``model=None`` trains fault-free but still
    watches, which catches numerically poisoned states).  engine: any of
    ``faults.faulty_sweep``'s engines (``colored_sweep``'s without a model).
    snapshot_dir: where the entry snapshot lives (None: in memory); a
    rollback restores it bitwise.  Returns the (possibly refactorized or
    rolled-back) problem, the final state and the receipt.
    """
    if model is not None and generator is None:
        raise ValueError("fault injection needs a torch.Generator")
    mem = _snapshot(problem, state, snapshot_dir)
    spr = config.sweeps_per_round

    def run_round(problem, state):
        if model is None:
            cand = sn_train.colored_sweep(problem, state, n_sweeps=spr, engine=engine)
        else:
            cand = faults_mod.faulty_sweep(
                problem, state, model, generator, n_sweeps=spr, engine=engine
            )
        return (cand,) + _host(_round_metrics(problem, state, cand))

    norm_prev = np.atleast_1d(weighted_norm_sq(problem, state).cpu().numpy())
    resid = np.full_like(norm_prev, np.inf)
    diverged = np.zeros(norm_prev.shape, bool)
    flags = retries = refactorized = rounds = sweeps = 0
    rolled_back = False

    for _ in range(config.max_rounds):
        cand, norm_new, resid_new = run_round(problem, state)
        rounds += 1
        sweeps += spr
        diverged = ~np.isfinite(norm_new) | (
            norm_new > norm_prev * config.divergence_ratio + 1e-9
        )
        if diverged.any():
            flags += 1
            if flags >= config.patience:
                flags = 0
                if retries < config.max_retries:
                    # discard the poisoned round; the next one draws fresh
                    # faults, so a transient burst does not kill the run
                    retries += 1
                    continue
                if not refactorized:
                    # the factors may have drifted: rebuild them from the
                    # Gram once (the retry budget stays spent)
                    problem = dataclasses.replace(problem, chol=rebuild_chol(problem))
                    refactorized = 1
                    continue
                # even fresh factors diverge: restore the entry snapshot
                # bitwise and stop
                problem, state = _rollback(problem, state, snapshot_dir, mem)
                rolled_back = True
                break
        else:
            flags = 0
        state = cand
        norm_prev = norm_new
        resid = resid_new
        if (resid < config.tol).all():
            break

    receipt = WatchdogReceipt(
        converged=resid < config.tol,
        residual=resid,
        norm=norm_prev,
        rounds=rounds,
        sweeps=sweeps,
        retries=retries,
        refactorized=refactorized,
        rolled_back=rolled_back,
        diverged=diverged,
    )
    return problem, state, receipt


def format_receipt(receipt: WatchdogReceipt) -> str:
    """One watchdog receipt line for the launcher."""
    n_conv = int(np.sum(receipt.converged))
    n_tot = int(receipt.converged.size)
    status = (
        "ROLLED BACK" if receipt.rolled_back
        else ("converged" if n_conv == n_tot else "partial")
    )
    return (
        f"watchdog: {status} {n_conv}/{n_tot} fields | "
        f"rounds={receipt.rounds} sweeps={receipt.sweeps} "
        f"retries={receipt.retries} refactorized={receipt.refactorized} | "
        f"max residual {float(np.max(receipt.residual)):.3e}"
    )
