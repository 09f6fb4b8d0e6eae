"""Query cells: one client in a closed loop of field-query requests.

Set-up trains the mix's B fields (``colored_sweep(engine="cuda")`` to the
configuration's sweep count on readings drawn from the seed) and prepares
the route: the kNN plan (``make_serving_plan`` over the deployment's
domain) for ``rule = "knn"``, the collapsed coefficients
(``fusion.global_coefficients``) for ``rule = "conn"``.  Request i asks
for Q points uniform on the domain, Q from the mix's fixed set of sizes in
an order drawn from the seed, and ends when its (B, Q) answers are in host
memory.  The check holds the program's build, its trained state, the
collapsed coefficients (conn) and the answers of a sample of requests
drawn from the seed, with the longest among them, against the reference.
"""

from __future__ import annotations

import contextlib

import torch

from .. import check, gen
from ..reference import build as rbuild
from ..reference import fusion as rfusion
from ..reference.precision import REFERENCE, Precision
from ..reference.sop import Sweeper
from .train import DTYPES, Port as TrainPort, build_readings, control_built

TIE = 1e-7  # squared-distance gap under which the k-th and (k+1)-th sensors tie


class Port:
    """The program: ``repro_torch`` trains, then answers through
    ``fusion.fuse(rule="knn", engine="cuda")`` or ``kernels.ops.kernel_matvec``."""

    def __init__(self, cfg: dict, mix: dict, b: rbuild.Build, ys: torch.Tensor, device):
        from repro_torch.core import fusion, make_serving_plan

        self.cfg, self.mix = cfg, mix
        self.train = TrainPort(cfg, b, ys.shape[0], device)
        self.state = self.train.run(ys, cfg["n_sweeps"])
        self.z, self.coef = self.state.z[:, : b.n], self.state.coef[:, : b.n]
        if mix["rule"] == "knn":
            lo, hi = cfg["domain"]
            self.plan = make_serving_plan(self.train.prob, k=mix["k"], lo=lo, hi=hi)
        else:
            self.anchors, self.cglob = fusion.global_coefficients(self.train.prob, self.state,
                                                                  rule="conn")

    def request(self, xq: torch.Tensor) -> torch.Tensor:
        from repro_torch.core import fusion
        from repro_torch.kernels import ops

        if self.mix["rule"] == "knn":
            return fusion.fuse(self.train.prob, self.state, xq, "knn", k=self.mix["k"],
                               engine="cuda", plan=self.plan)
        return ops.kernel_matvec(xq, self.anchors, self.cglob, gamma=self.cfg["gamma"])

    def built(self) -> dict:
        return self.train.built()

    def collapsed(self) -> torch.Tensor:
        return self.cglob


class Control:
    """The reference in the program's place, computed in the control's precision."""

    def __init__(self, cfg: dict, mix: dict, b: rbuild.Build, ys: torch.Tensor, device,
                 prec: Precision):
        self.cfg, self.mix, self.b, self.prec = cfg, mix, b, prec
        self.sw = Sweeper(b, cfg["gamma"], prec, device)
        self.z, self.coef = self.sw.sweep(ys, cfg["n_sweeps"])
        if mix["rule"] == "conn":
            self.cglob = rfusion.conn_coefficients(b, self.coef, prec)

    def request(self, xq: torch.Tensor) -> torch.Tensor:
        g = self.cfg["gamma"]
        if self.mix["rule"] == "knn":
            return rfusion.knn_answers(self.b, self.coef, xq, self.mix["k"], g, self.prec, 0.0)[0]
        return rfusion.conn_answers(self.b, self.cglob, xq, g, self.prec)

    def built(self) -> dict:
        return control_built(self.b, self.sw)

    def collapsed(self) -> torch.Tensor:
        return self.cglob


class Cell:
    """One query cell: set-up, the window's requests, the check."""

    def __init__(self, ctx):
        self.ctx = ctx
        cfg, mix = ctx.config, ctx.traffic
        self.fields, self.dim = mix["fields"], cfg["dim"]
        self.dt = DTYPES[cfg["dtype"]]
        self.sizes = gen.sizes(mix["sizes"], ctx.seed)
        self.gen = torch.Generator(device=ctx.device)
        self.sample = gen.Reservoir(mix["checked_requests"], ctx.seed)
        self.longest = None  # (i, answers) of the first request of the largest size
        axis = ctx.build.positions[:, mix["readings"]["axis"]]
        self.axis = torch.as_tensor(axis, device=ctx.device).to(self.dt)

    def _state_readings(self) -> torch.Tensor:
        return gen.readings(self.ctx.traffic["readings"], self.axis, self.fields, self.ctx.seed,
                            gen.READINGS, 0, self.gen)

    def _points(self, i: int, q: int, stream_seed: int | None = None) -> torch.Tensor:
        seed = self.ctx.seed if stream_seed is None else stream_seed
        return gen.points(self.ctx.config["domain"], q, self.dim, seed, i, self.gen, self.dt)

    def setup(self) -> None:
        ctx = self.ctx
        ys = self._state_readings()
        if ctx.control is None:
            self.program = Port(ctx.config, ctx.traffic, ctx.build, ys, ctx.device)
        else:
            self.program = Control(ctx.config, ctx.traffic, ctx.build, ys, ctx.device, ctx.control)
        top = max(self.sizes) * self.fields
        pin = ctx.device.type == "cuda"
        self.host = torch.empty((top,), dtype=self.dt, pin_memory=pin)
        for j, q in enumerate(sorted(set(self.sizes))):  # every size this mix sends
            self._answer(self._points(j, q, stream_seed=gen.item_seed(ctx.seed, gen.WARM, 0)))

    def _answer(self, xq: torch.Tensor, span=lambda name: contextlib.nullcontext()):
        """The B fields' answers at ``xq``, in (pinned) host memory."""
        with span("portbench.request"):
            out = self.program.request(xq)
        with span("portbench.copy_out"):
            host = self.host[: out.numel()].view(out.shape)
            host.copy_(out, non_blocking=True)
            self.ctx.sync()
        return host

    def item(self, i: int, span) -> int:
        """Request i: Q points, the B fields' answers in host memory;
        returns the field-queries answered."""
        q = self.sizes[i % len(self.sizes)]
        with span("portbench.points"):
            xq = self._points(i, q)
        host = self._answer(xq, span)
        slot = self.sample.wants()
        if slot is not None:
            self.sample.put(slot, i, host.clone())
        if self.longest is None and q == max(self.sizes):
            self.longest = (i, host.clone())
        return q * self.fields

    def check(self) -> dict[str, float]:
        ctx, b, mix = self.ctx, self.ctx.build, self.ctx.traffic
        g, dev = ctx.config["gamma"], ctx.device
        out = build_readings(b, self.program.built(), g, dev)
        z_p, coef_p = self.program.z, self.program.coef
        cglob_p = self.program.collapsed() if mix["rule"] == "conn" else None
        del self.program  # the program's state is freed before the reference runs
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        ref = Sweeper(b, g, REFERENCE, dev)
        z_r, coef_r = ref.sweep(self._state_readings(), ctx.config["n_sweeps"])
        mask = torch.as_tensor(b.nbr_mask, device=dev)
        out.update(state_z_err=check.field_err(z_p, z_r),
                   state_coef_err=check.field_err(coef_p, coef_r, mask))
        if cglob_p is not None:
            cg_r = rfusion.conn_coefficients(b, coef_r, REFERENCE)
            full = torch.cat([cg_r, cg_r.new_zeros((cg_r.shape[0], cglob_p.shape[1] - b.n))], 1)
            out["cglob_err"] = check.field_err(cglob_p, full)
            self.nonzero = (cg_r != 0).sum(dim=1)
        kept = list(self.sample.kept)
        if self.longest is not None and self.longest[0] not in {i for i, _ in kept}:
            kept.append(self.longest)
        self.item_readings = []
        for i, ans in kept:
            xq = self._points(i, ans.shape[1])
            ans = ans.to(dev)
            if mix["rule"] == "knn":
                a, alt, tie = rfusion.knn_answers(b, coef_r, xq, mix["k"], g, REFERENCE, TIE)
                a64 = ans.to(torch.float64)
                gap = torch.where(tie[None], torch.minimum((a64 - a).abs(), (a64 - alt).abs()),
                                  (a64 - a).abs())
                err = check.field_err(ans, a, gap=gap)
            else:
                err = check.field_err(ans, rfusion.conn_answers(b, cg_r, xq, g, REFERENCE))
            self.item_readings.append(dict(answer_err=err))
        out["answer_err"] = check.worst(*(r["answer_err"] for r in self.item_readings))
        return out

    def work(self) -> dict:
        """What the per-layer readers count the work from."""
        c = self.ctx
        return dict(kind="query", rule=c.traffic["rule"], build=c.build, fields=self.fields,
                    k=c.traffic.get("k"), dim=self.dim, points=self._points,
                    nonzero=getattr(self, "nonzero", None))
