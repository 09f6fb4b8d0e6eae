"""Training cells: a closed loop of ``colored_sweep(engine="cuda")`` calls.

Each call trains the mix's B fields over the deployment's fixed network to
the configuration's sweep count, on fresh readings drawn for that call, and
ends synchronised.  The check holds the program's build (neighbourhoods,
colouring, Gram blocks, factors) and the swept state (z and coef) of a
sample of the window's calls, drawn from the seed, against the reference.
"""

from __future__ import annotations

import torch

from .. import check, gen
from ..reference import build as rbuild
from ..reference.precision import REFERENCE, Precision
from ..reference.sop import Sweeper

DTYPES = {"float32": torch.float32, "float64": torch.float64}


class Port:
    """The program: ``repro_torch``'s build, then ``colored_sweep(engine="cuda")``."""

    def __init__(self, cfg: dict, b: rbuild.Build, fields: int, device):
        from repro_torch.core import Kernel, build_topology, init_state, make_batch_problem

        dt = DTYPES[cfg["dtype"]]
        topo = build_topology(b.positions, cfg["radius"], device=device)
        self.prob = make_batch_problem(
            topo, Kernel("rbf", gamma=cfg["gamma"]), torch.zeros((fields, b.n), dtype=dt),
            b.lambdas, dtype=dt, device=device)
        st = init_state(self.prob)
        self.z0, self.coef0, self.n = st.z, st.coef, b.n

    def run(self, ys: torch.Tensor, n_sweeps: int):
        """The whole trained state, as ``colored_sweep`` returns it."""
        from repro_torch.core import SNTrainState, sn_train

        self.z0[:, : self.n].copy_(ys)
        return sn_train.colored_sweep(self.prob, SNTrainState(self.z0, self.coef0), n_sweeps,
                                      engine="cuda")

    def sweep(self, ys: torch.Tensor, n_sweeps: int):
        """(z, coef) of the sensors: views of ``run``'s state."""
        st = self.run(ys, n_sweeps)
        return st.z[:, : self.n], st.coef[:, : self.n]

    def built(self) -> dict:
        p, n = self.prob, self.n
        return dict(nbr_idx=p.nbr_idx[:n], nbr_mask=p.nbr_mask[:, :n], colors=p.topology.colors[:n],
                    gram=p.gram[:, :n], chol=p.chol[:, :n])


class Control:
    """The reference in the program's place, computed in the control's precision."""

    def __init__(self, cfg: dict, b: rbuild.Build, fields: int, device, prec: Precision):
        self.b, self.sw = b, Sweeper(b, cfg["gamma"], prec, device)

    def sweep(self, ys: torch.Tensor, n_sweeps: int):
        return self.sw.sweep(ys, n_sweeps)

    def built(self) -> dict:
        return control_built(self.b, self.sw)


def control_built(b: rbuild.Build, sw: Sweeper) -> dict:
    """The control's build, in the program's terms (one field's blocks)."""
    dev = sw.device
    chol = torch.linalg.cholesky_ex(rbuild.systems(b, sw.gram)).L
    return dict(nbr_idx=torch.as_tensor(b.nbr_idx, device=dev),
                nbr_mask=torch.as_tensor(b.nbr_mask, device=dev)[None],
                colors=torch.as_tensor(b.colors, device=dev), gram=sw.gram[None], chol=chol[None])


def build_readings(b: rbuild.Build, built: dict, gamma: float, device) -> dict[str, float]:
    """The program's build against the reference's: ``build`` counts the
    sensors whose neighbourhood or colour differs (exact: 0); ``gram_err``
    and ``chol_err`` compare the Gram blocks and the factors of
    ``K_s + lambda_s I`` on the real lanes, field by field."""
    mask_r = torch.as_tensor(b.nbr_mask, device=device)
    idx_r = torch.as_tensor(b.nbr_idx, device=device)
    mask_p = built["nbr_mask"].to(device)
    same_mask = (mask_p == mask_r[None]).all(dim=(0, 2))
    same_idx = torch.where(mask_r, built["nbr_idx"].to(device).long() == idx_r, True).all(dim=1)
    same_col = built["colors"].to(device).long() == torch.as_tensor(b.colors, device=device)
    gram_r = rbuild.gram_blocks(b, gamma, REFERENCE, device)
    chol_r = torch.linalg.cholesky(rbuild.systems(b, gram_r))
    outer = mask_r[:, :, None] & mask_r[:, None, :]
    lanes = outer.tril()
    gram_err = chol_err = 0.0
    for f0 in range(0, built["gram"].shape[0], 16):  # fields in blocks
        gram_err = max(gram_err, check.field_err(built["gram"][f0:f0 + 16], gram_r[None].expand(
            min(16, built["gram"].shape[0] - f0), -1, -1, -1), outer))
        chol_err = max(chol_err, check.field_err(built["chol"][f0:f0 + 16], chol_r[None].expand(
            min(16, built["chol"].shape[0] - f0), -1, -1, -1), lanes))
    return dict(build=float((~(same_mask & same_idx & same_col)).sum()), gram_err=gram_err,
                chol_err=chol_err)


class Cell:
    """One training cell: set-up, the window's calls, the check."""

    def __init__(self, ctx):
        self.ctx = ctx
        cfg, mix = ctx.config, ctx.traffic
        self.fields, self.sweeps = mix["fields"], cfg["n_sweeps"]
        self.dt = DTYPES[cfg["dtype"]]
        self.axis = torch.as_tensor(ctx.build.positions[:, mix["readings"]["axis"]],
                                    device=ctx.device).to(self.dt)
        self.gen = torch.Generator(device=ctx.device)
        self.sample = gen.Reservoir(mix["checked_calls"], ctx.seed)

    def setup(self) -> None:
        ctx = self.ctx
        if ctx.control is None:
            self.program = Port(ctx.config, ctx.build, self.fields, ctx.device)
        else:
            self.program = Control(ctx.config, ctx.build, self.fields, ctx.device, ctx.control)
        for w in range(self.ctx.traffic["warm_calls"]):  # the one shape this cell runs
            self.program.sweep(self._readings(gen.WARM, w), self.sweeps)
        ctx.sync()

    def _readings(self, stream: int, i: int) -> torch.Tensor:
        return gen.readings(self.ctx.traffic["readings"], self.axis, self.fields, self.ctx.seed,
                            stream, i, self.gen)

    def item(self, i: int, span) -> int:
        """Call i: fresh readings, one training call, synchronised; returns
        the fields trained."""
        with span("portbench.readings"):
            ys = self._readings(gen.READINGS, i)
        with span("portbench.colored_sweep"):
            out = self.program.sweep(ys, self.sweeps)
        with span("portbench.sync"):
            self.ctx.sync()
        slot = self.sample.wants()
        if slot is not None:
            self.sample.put(slot, i, out)
        return self.fields

    def check(self) -> dict[str, float]:
        ctx, b = self.ctx, self.ctx.build
        out = build_readings(b, self.program.built(), ctx.config["gamma"], ctx.device)
        del self.program  # the program's state is freed before the reference runs
        if ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        ref = Sweeper(b, ctx.config["gamma"], REFERENCE, ctx.device)
        mask = torch.as_tensor(b.nbr_mask, device=ctx.device)
        self.item_readings = []
        for i, (z, coef) in self.sample.kept:
            z_r, coef_r = ref.sweep(self._readings(gen.READINGS, i), self.sweeps)
            self.item_readings.append(dict(z_err=check.field_err(z, z_r),
                                           coef_err=check.field_err(coef, coef_r, mask)))
        for k in ("z_err", "coef_err"):
            out[k] = check.worst(*(r[k] for r in self.item_readings))
        return out

    def work(self) -> dict:
        """What the per-layer readers count the work from."""
        return dict(kind="train", build=self.ctx.build, fields=self.fields, sweeps=self.sweeps,
                    dtype=self.ctx.config["dtype"])
