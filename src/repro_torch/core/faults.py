"""Fault injection for SN-Train: lossy links, bursts and sensor crashes.

Port of ``repro.core.faults``.  The paper's setting is message passing
over wireless links (Sec. 4), where delivery is lossy and bursty and
sensors crash mid-training.  This module is the seeded fault process that
drives the degraded paths of ``sn_train``:

  * **i.i.d. drops**: every padded neighbor lane ``(s, k)`` of every sweep
    loses its outgoing message write with probability ``drop``;
  * **Gilbert-Elliott bursts**: each lane carries a two-state Markov link
    (good/bad); the bad state adds ``drop_bad`` loss on top of ``drop``,
    and ``burst_to_bad`` / ``burst_to_good`` set the burst length.  The
    chain starts at its stationary distribution;
  * **crash/restart schedules**: a per-sensor up/down Markov chain that
    starts all-up and runs through ``robust_sweep``'s per-sweep masked
    refactorization, so a down sensor neither updates nor is read.

A dropped message holds its last value: the sender still runs its local
projection, but the write to the target slot never lands.  An
all-delivered mask is therefore a bitwise identity, engine by engine.

Randomness comes from an explicit ``torch.Generator`` on the problem's
device.  The draw order is the reference's structure: every sweep draws
its three uniforms (deliver, to-bad, to-good) whatever the rates, so under
one seed a higher drop rate only shrinks the delivered set (delivery
thresholds a uniform, ``u >= p``); delivery is drawn before the crash
trace, so a crash model and a crash-free one of the same seed get the same
``delivered``.  The rates are 0-d tensors (operands, never constants of a
kernel), and nothing here reads a rate or a mask on the host.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import device as _device
from . import sn_train
from .sn_train import SNTrainProblem, SNTrainState


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """Seeded link/sensor fault process; every rate is a 0-d tensor.

    ``crash``/``restart`` are ``None`` for the crash-free model: a
    structural distinction, so the crash-free path never pays
    ``robust_sweep``'s per-sweep refactorization.  Build with
    ``make_fault_model``.
    """

    drop: torch.Tensor  # () ambient P(per-lane message drop per sweep)
    burst_to_bad: torch.Tensor  # () P(good -> bad) per sweep
    burst_to_good: torch.Tensor  # () P(bad -> good) per sweep
    drop_bad: torch.Tensor  # () extra drop probability in the bad state
    crash: torch.Tensor | None = None  # () P(an up sensor crashes per sweep)
    restart: torch.Tensor | None = None  # () P(a down sensor restarts per sweep)

    @property
    def has_crash(self) -> bool:
        return self.crash is not None


def make_fault_model(
    drop: float = 0.0,
    burst: tuple | None = None,
    crash: tuple | None = None,
    *,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device = "cuda",
) -> FaultModel:
    """A FaultModel of 0-d ``dtype`` tensors on ``device``.

    drop: ambient i.i.d. per-lane drop probability.
    burst: optional ``(to_bad, to_good, drop_bad)`` Gilbert-Elliott
        parameters (None: the chain never leaves the good state).
    crash: optional ``(p_crash, p_restart)`` per-sensor Markov rates
        (None: the crash-free, refactorization-free path).
    """
    dev = _device.resolve(device)
    z = lambda v: torch.tensor(v, dtype=dtype, device=dev)  # noqa: E731
    to_bad, to_good, drop_bad = burst if burst is not None else (0.0, 1.0, 0.0)
    return FaultModel(
        drop=z(drop),
        burst_to_bad=z(to_bad),
        burst_to_good=z(to_good),
        drop_bad=z(drop_bad),
        crash=None if crash is None else z(crash[0]),
        restart=None if crash is None else z(crash[1]),
    )


def link_masks(
    model: FaultModel, generator: torch.Generator, n_sweeps: int, lane_shape: tuple
) -> torch.Tensor:
    """Per-sweep delivered masks, shape ``(n_sweeps,) + lane_shape`` bool.

    ``lane_shape`` is the padded neighbor table's ``(n+1, D)``: delivery
    is a property of the physical lane, shared across fields.  The chain's
    initial state is drawn first, then three uniforms per sweep (deliver,
    to-bad, to-good), all in the model's dtype.  Within a sweep a lane
    drops with probability ``1 - (1-drop) * (1 - drop_bad * [bad])``.
    The comparisons run over every sweep at once; the chain itself takes
    one launch per sweep.
    """
    lane_shape = tuple(lane_shape)
    dt, dev = model.drop.dtype, model.drop.device
    denom = model.burst_to_bad + model.burst_to_good
    pi_bad = torch.where(denom > 0, model.burst_to_bad / torch.clamp(denom, min=1e-20), 0.0)
    bad = torch.empty((n_sweeps + 1,) + lane_shape, dtype=torch.bool, device=dev)
    bad[0] = torch.rand(lane_shape, generator=generator, dtype=dt, device=dev) < pi_bad
    u = torch.rand((n_sweeps, 3) + lane_shape, generator=generator, dtype=dt, device=dev)
    stay_bad, go_bad = ~(u[:, 2] < model.burst_to_good), u[:, 1] < model.burst_to_bad
    for t in range(n_sweeps):
        torch.where(bad[t], stay_bad[t], go_bad[t], out=bad[t + 1])
    # the drop probability of either state, rounded as the expression above
    keep = 1.0 - model.drop
    p_drop = torch.where(bad[:n_sweeps], 1.0 - keep * (1.0 - model.drop_bad), 1.0 - keep)
    return u[:, 0] >= p_drop


def crash_schedule(
    model: FaultModel, generator: torch.Generator, n_sweeps: int, n: int
) -> torch.Tensor:
    """Per-sensor up/down Markov chain, shape ``(n_sweeps, n)`` bool.

    Starts all-up (the problem's persistent ``alive`` composes on top inside
    ``robust_sweep``, so lifecycle-dead rows stay dead); two uniforms per
    sweep (crash, restart).
    """
    dev = model.drop.device
    if model.crash is None:
        return torch.ones((n_sweeps, n), dtype=torch.bool, device=dev)
    u = torch.rand((n_sweeps, 2, n), generator=generator, dtype=model.crash.dtype, device=dev)
    stay_up, restart = ~(u[:, 0] < model.crash), u[:, 1] < model.restart
    up = torch.ones((n_sweeps + 1, n), dtype=torch.bool, device=dev)
    for t in range(n_sweeps):
        torch.where(up[t], stay_up[t], restart[t], out=up[t + 1])
    return up[1:]


def sample_faults(
    model: FaultModel,
    generator: torch.Generator,
    n_sweeps: int,
    problem: SNTrainProblem,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(delivered (n_sweeps, n+1, D), alive trace (n_sweeps, n) or None);
    delivery is drawn before the crash trace."""
    delivered = link_masks(model, generator, n_sweeps, problem.nbr_idx.shape)
    alive_tn = (
        crash_schedule(model, generator, n_sweeps, problem.n) if model.has_crash else None
    )
    return delivered, alive_tn


def _faulty(problem, state, model, delivered, alive_tn, n_sweeps, engine):
    """The dispatch of ``faulty_sweep`` on given masks."""
    if engine == "serial":
        if model.has_crash:
            raise NotImplementedError(
                "crash schedules dispatch the colored robust path; "
                "use engine='plan'/'onehot'/'cuda'"
            )
        return sn_train.serial_sweep(problem, state, n_sweeps=n_sweeps, delivered=delivered)
    if model.has_crash:
        return sn_train._robust_colored(problem, state, alive_tn, n_sweeps, engine, delivered)
    return sn_train.colored_sweep(
        problem, state, n_sweeps=n_sweeps, engine=engine, delivered=delivered
    )


def faulty_sweep(
    problem: SNTrainProblem,
    state: SNTrainState,
    model: FaultModel,
    generator: torch.Generator,
    n_sweeps: int = 1,
    *,
    engine: str = "plan",
) -> SNTrainState:
    """Run ``n_sweeps`` sweeps under the fault model.

    Samples the delivery masks (and, when the model crashes sensors, the
    alive trace) on the device from ``generator``, then dispatches:

      * crash-free models -> the cached-factor engines (``serial_sweep`` /
        ``colored_sweep``) with ``delivered``: no refactorization, and one
        ``color_sweep`` launch per call with the ``cuda`` engine;
      * crashing models   -> ``robust_sweep``'s path, which refactors the
        masked systems per sweep and composes ``delivered`` on top (one
        launch per sweep with ``cuda``).

    ``engine``: "serial", or the colored engines "plan"/"onehot"/"cuda";
    "serial" with a crash model raises ``NotImplementedError``.
    """
    delivered, alive_tn = sample_faults(model, generator, n_sweeps, problem)
    return _faulty(problem, state, model, delivered, alive_tn, n_sweeps, engine)


_FAULT_SPEC_USAGE = (
    "usage: drop=P[,burst=to_bad:to_good:drop_bad][,crash=p_crash:p_restart]"
    " — every rate a probability in [0, 1], each key at most once"
    " (e.g. drop=0.1,burst=0.05:0.4:0.5)"
)

# key -> per-position rate names, used in the error messages
_FAULT_SPEC_KEYS = {
    "drop": ("drop",),
    "burst": ("to_bad", "to_good", "drop_bad"),
    "crash": ("p_crash", "p_restart"),
}


def parse_fault_spec(
    spec: str,
    *,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device = "cuda",
) -> FaultModel:
    """Parse and validate the CLI fault spec.

    ``drop=P[,burst=GB:BG:PB][,crash=C:R]``, e.g. ``drop=0.1``,
    ``drop=0.05,burst=0.02:0.3:0.6``, ``drop=0.1,crash=0.01:0.25``.
    Unknown or repeated keys, wrong arity, non-numeric values and rates
    outside [0, 1] raise ``ValueError`` with the usage line.
    """
    if not spec.strip():
        raise ValueError(f"empty fault spec; {_FAULT_SPEC_USAGE}")
    seen: dict[str, tuple] = {}
    for part in filter(None, (p.strip() for p in spec.split(","))):
        if "=" not in part:
            raise ValueError(
                f"bad fault spec field {part!r} in {spec!r}; {_FAULT_SPEC_USAGE}"
            )
        name, _, val = part.partition("=")
        name = name.strip()
        if name not in _FAULT_SPEC_KEYS:
            raise ValueError(
                f"unknown fault spec key {name!r} in {spec!r}; {_FAULT_SPEC_USAGE}"
            )
        if name in seen:
            raise ValueError(
                f"repeated fault spec key {name!r} in {spec!r}; {_FAULT_SPEC_USAGE}"
            )
        rate_names = _FAULT_SPEC_KEYS[name]
        raw = val.split(":")
        if len(raw) != len(rate_names):
            raise ValueError(
                f"{name} takes {len(rate_names)} value(s) "
                f"({':'.join(rate_names)}), got {val!r}; {_FAULT_SPEC_USAGE}"
            )
        vals = []
        for rname, v in zip(rate_names, raw):
            try:
                rate = float(v)
            except ValueError:
                raise ValueError(
                    f"non-numeric {name} rate {rname}={v!r} in {spec!r}; "
                    f"{_FAULT_SPEC_USAGE}"
                ) from None
            if not (0.0 <= rate <= 1.0):  # also rejects nan
                raise ValueError(
                    f"{name} rate {rname}={v} outside [0, 1] in {spec!r}; "
                    f"{_FAULT_SPEC_USAGE}"
                )
            vals.append(rate)
        seen[name] = tuple(vals)
    return make_fault_model(
        seen.get("drop", (0.0,))[0],
        seen.get("burst"),
        seen.get("crash"),
        dtype=dtype,
        device=device,
    )
