"""Driver `admm_consensus`: DOGS' ADMM phase over ranks, one block a rank.

The program's `MasterTrainer(distributed=True)` over 2x2 blocks, one
process and card a block, entered into phase 2 at `admm_start_step` from a
global model drawn from the seed, through the fusion's own entry
(`start_admm`). The scene: Gaussians filling a 2W x 2H footprint at depth
2-10 under the cameras, cut into 2 x 2 cells whose boxes, grown by
`bbox_scale_factor` about their centres, select each block's Gaussians
(neighbours overlap: the shared rows the rounds reconcile). Each block
trains 8 aerial views over its cell against the benchmark's plain renders
of a teacher scene, 8-bit as the program stores them.

Set-up: the teacher's renders (benchmark, not metered), the model and the
ranks (program), phase-2 steps 1-3 (the checked steps: each block's losses,
its first gradient read from the moments and its change after step 3,
gathered to rank 0), the rest of the first interval, its round (checked
against the plain dense round over the blocks' states gathered to rank 0),
the `post_round_steps` steps after it (checked against the plain steps from
each block's state gathered after the round: parameters, duals, z_local,
rho, moments and mask, so that the penalty is away from zero), and one warm
interval. The window calls `train_iteration()` (an interval and its round)
until it ends; `train_step_ms` is its length over the master steps
completed, the last one synchronized on every rank. A traced run profiles
one interval on rank 0, then times `timed_rounds` rounds from every rank
drained to the residuals on rank 0's host.

The control (`round_dtype` "bfloat16" in the configuration, with the
harness's `reduce_dtype` "bf16") computes the plain round's sums in
bfloat16 where the configuration states float32.
"""

from __future__ import annotations

import concurrent.futures
import multiprocessing
import sys
import time

import numpy as np
import torch

from benchmark import compare, program, scenes
from benchmark.counts import admm as admm_counts
from benchmark.reference import admm as ref_admm
from benchmark.traffic.train_step import raster_config, reference_render

GLOBAL, TEACHER = 1, 2  # streams of draws
LEAVES = ref_admm.LEAVES
ROWS = ("params", "u", "z_local", "mu", "nu")  # a block's per-Gaussian state after the round
MASK = ("mask_params", "mask_mu", "mask_nu")


def grid_scene(n: int, seed: int, stream: int, device, traffic: dict, sh_rest: float) -> dict:
    """n Gaussians of SH degree 3 over x in [-W, W], y in [-H, H] at depth
    z in `depth`, 2-4 px footprints at f 1000 (as scenes.box_scene)."""
    g = scenes.generator(seed, stream, device)
    u = torch.rand((n, 9), generator=g, device=device)
    hw, hh, (z0, z1) = traffic["half_width"], traffic["half_height"], traffic["depth"]
    xyz = torch.tensor([-hw, -hh, z0], device=device) + u[:, 0:3] * torch.tensor([2 * hw, 2 * hh, z1 - z0],
                                                                                 device=device)
    scale = xyz[:, 2:3] / 1000.0 * (1.5 + 2.5 * u[:, 3:4])
    normal = torch.randn((n, 4 + 45), generator=g, device=device)
    opacity = 0.3 + 0.6 * u[:, 7:8]
    return dict(
        xyz=xyz,
        feat_dc=((u[:, 4:7] - 0.5) / scenes.SH_C0)[:, None, :],
        feat_rest=(normal[:, 4:] * sh_rest).reshape(n, 15, 3),
        log_scale=torch.log(scale).repeat(1, 3),
        quat=normal[:, 0:4].contiguous(),
        logit_opacity=torch.log(opacity / (1 - opacity)),
    )


def cells(cfg: dict, traffic: dict) -> tuple[np.ndarray, np.ndarray]:
    """((B, 2, 2) cells, (B, 2, 2) grown boxes) as [[x0, y0], [x1, y1]],
    block k = iy * mx + ix."""
    mx, my, f = cfg["mx"], cfg["my"], cfg["bbox_scale_factor"]
    hw, hh = traffic["half_width"], traffic["half_height"]
    cw, ch = 2 * hw / mx, 2 * hh / my
    out, grown = [], []
    for iy in range(my):
        for ix in range(mx):
            lo = np.array([-hw + ix * cw, -hh + iy * ch])
            hi = lo + [cw, ch]
            c, half = (lo + hi) / 2, f * np.array([cw, ch]) / 2
            out.append([lo, hi])
            grown.append([c - half, c + half])
    return np.asarray(out, np.float64), np.asarray(grown, np.float64)


def block_ids(xyz: torch.Tensor, grown: np.ndarray) -> list[np.ndarray]:
    """Each block's Gaussians: those inside its grown box (bounds
    inclusive)."""
    out = []
    for (x0, y0), (x1, y1) in grown:
        x, y = xyz[:, 0], xyz[:, 1]
        inside = (x >= x0) & (x <= x1) & (y >= y0) & (y <= y1)
        out.append(inside.nonzero()[:, 0].to(torch.int32).cpu().numpy())
    return out


def block_poses(cfg: dict, traffic: dict, boxes: np.ndarray) -> list[list[dict]]:
    """Each block's aerial views: the bench cameras' rotations, moved over
    the block's cell (centres spread over its middle third)."""
    n = traffic["views_per_block"]
    out = []
    for (lo, hi) in boxes:
        centre, size = (lo + hi) / 2, hi - lo
        poses = []
        for i, p in enumerate(scenes.bench_poses(n, cfg["width"], cfg["height"])):
            a, b = (i % 3 - 1) / 6.0, ((i * 5) % 3 - 1) / 6.0
            c = np.array([centre[0] + a * size[0], centre[1] + b * size[1], 0.0])
            poses.append(dict(p, t=-p["R"] @ c))
        out.append(poses)
    return out


def trainer_config(cfg: dict):
    from dogs_tpu_torch.train.trainer import TrainerConfig

    keys = ("max_iterations", "lambda_dssim", "lambda_scale", "lambda_mask", "mask_lr", "position_lr_init",
            "position_lr_final", "position_lr_delay_mult", "position_lr_max_steps", "feature_lr", "opacity_lr",
            "scaling_lr", "quaternion_lr", "percent_dense", "densify_start_iter", "densify_end_iter",
            "densification_interval", "opacity_reset_interval", "densify_grad_threshold", "max_sh_degree",
            "sh_increase_interval", "prune_percent", "prune_decay", "prune_v_pow")
    return TrainerConfig(use_appearance_mask=bool(cfg["mask"]), prune_iterations=tuple(cfg["prune_iterations"]),
                         **{k: cfg[k] for k in keys})


def admm_config(cfg: dict):
    from dogs_tpu_torch.parallel.admm import AdmmConfig

    keys = ("consensus_interval", "over_relaxation_coeff", "alpha_xyz", "alpha_fdc", "alpha_fr", "alpha_s",
            "alpha_q", "alpha_o", "stop_adapt_iter", "mu", "tau_inc", "tau_dec")
    return AdmmConfig(**{k: cfg[k] for k in keys})


def rel_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm((a - b).double())) / max(float(torch.linalg.vector_norm(b.double())), 1e-30)


class AdmmRun:
    def __init__(self, cfg, traffic, seed, device, meter):
        from dogs_tpu_torch.data.blocks import BlockPartition
        from dogs_tpu_torch.parallel.master import MasterTrainer

        if not hasattr(MasterTrainer, "start_admm"):  # a program without the ranks fails at once
            raise RuntimeError("the program's MasterTrainer has no start_admm: no ADMM phase over ranks")
        cfg = {**cfg, **traffic.get("overrides", {})}
        acfg = admm_config(cfg)
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, torch.device(device)
        dev = self.device
        marks = [("start", time.perf_counter())]
        self.cells, grown = cells(cfg, traffic)
        self.poses = block_poses(cfg, traffic, self.cells)
        teacher = grid_scene(traffic["n_teacher"], seed, TEACHER, dev, traffic, sh_rest=0.0)
        self.gts = [[torch.round(torch.clamp(reference_render(teacher, p, dev, 0, cfg["max_tiles_per_gaussian"]),
                                             0.0, 1.0) * 255.0) / 255.0 for p in poses] for poses in self.poses]
        del teacher
        program.free(dev)
        marks.append(("gt", time.perf_counter()))

        meter.start()
        leaves = grid_scene(traffic["n_global"], seed, GLOBAL, dev, traffic, traffic["sh_rest"])
        self.ids = block_ids(leaves["xyz"], grown)
        self.n_shared = admm_counts.shared_row_count(self.ids)
        b = len(self.ids)
        partition = BlockPartition(num_blocks=b, transform=np.eye(4), camera_labels=np.repeat(np.arange(b),
                                   traffic["views_per_block"]), bounds=self.cells, bounds_expanded=grown,
                                   point_masks=[], point_bounds=self.cells, point_bounds_expanded=grown)
        cams = [[program.camera(p, dev, i) for i, p in enumerate(poses)] for poses in self.poses]
        images = [[g.cpu().numpy() for g in gts] for gts in self.gts]
        self.master = MasterTrainer(
            partition, None, None, cams, images, trainer_config(cfg), raster_config(cfg), acfg,
            spatial_lr_scale=traffic["spatial_lr_scale"], seed=cfg["seed"], device=dev.type, distributed=True,
            rank_timeout_s=traffic["rank_timeout_s"])
        self.ranks = self.master.world
        marks.append(("ranks", time.perf_counter()))
        m = self.master
        m.start_admm(leaves, self.ids, step=cfg["admm_start_step"])
        marks.append(("start_admm", time.perf_counter()))
        self.n_rows = [len(i) for i in self.ids]
        losses = [[] for _ in range(b)]
        grads = None
        for i in range(traffic["check_steps"]):
            for k, metrics in enumerate(m.train_step()):
                losses[k].append(float(metrics["loss"]))
            if i == 0:
                meter.stop()
                grads = [compare.norms({k: v / 0.1 for k, v in mu.items()}) for mu in m.gather_blocks("mu")]
                program.free(dev)
                meter.start()
        meter.stop()
        change = []
        for ids, x in zip(self.ids, m.gather_blocks("params")):
            sel = torch.as_tensor(ids, dtype=torch.int64, device=dev)
            change.append(compare.norms({k: x[k][: len(ids)] - leaves[k][sel] for k in LEAVES}))
        del leaves, x
        program.free(dev)
        self.prog = dict(losses=losses, grad=grads, change=change)
        meter.start()
        for _ in range(acfg.consensus_interval - traffic["check_steps"]):
            m.train_step()
        meter.stop()
        marks.append(("checked_interval", time.perf_counter()))
        self.round_readings = self.check_round(acfg)
        program.free(dev)
        marks.append(("round_check", time.perf_counter()))
        self.post = self.post_round_steps()
        program.free(dev)
        marks.append(("post_round", time.perf_counter()))
        meter.start()
        m.train_iteration()  # the warm interval
        m.sync()
        marks.append(("warm", time.perf_counter()))
        print("admm set-up: " + ", ".join(f"{name} {t - t0:.2f} s" for (_, t0), (name, t) in zip(marks, marks[1:]))
              + f"; {self.ranks} ranks, blocks of {[len(i) for i in self.ids]}, {self.n_shared} shared rows",
              file=sys.stderr)

    def check_round(self, acfg) -> dict:
        """The first round against the plain dense round over the blocks'
        states gathered to rank 0."""
        m, dev = self.master, self.device
        before = {kind: m.gather_blocks(kind) for kind in ("params", "alive", "slot_map", "u", "z_local")}
        rho = dict(m.rho)
        program.sync(dev)
        primal, dual = m.consensus()
        after = {kind: m.gather_blocks(kind) for kind in ("u", "z_local")}
        rank_rho = [np.asarray([r[k] for k in LEAVES], np.float32).view(np.uint32) for r in m.rank_states()]
        alive = [a["alive"] for a in before["alive"]]
        ref = ref_admm.consensus_round(before["params"], alive, [s["slot_map"] for s in before["slot_map"]],
                                       before["u"], before["z_local"], rho, m.n_global, acfg.over_relaxation_coeff,
                                       sum_dtype=torch.bfloat16 if self.cfg.get("round_dtype") == "bfloat16"
                                       else torch.float64)
        z_gap = u_gap = 0.0
        for kb, al in enumerate(alive):
            for k in LEAVES:
                x = before["params"][kb][k][al]
                z_gap = max(z_gap, rel_gap(after["z_local"][kb][k][al], ref["z_local"][kb][k][al]))
                u_gap = max(u_gap, float(torch.linalg.vector_norm((after["u"][kb][k][al] - ref["u"][kb][k][al])
                                                                  .double())) /
                            max(float(torch.linalg.vector_norm(x.double())), 1e-30))
        got = [float(primal[k]) for k in LEAVES] + [float(dual[k]) for k in LEAVES]
        want = [ref["primal"][k] for k in LEAVES] + [ref["dual"][k] for k in LEAVES]
        residual_gap = max(abs(g - w) / max(abs(w), 1e-30) for g, w in zip(got, want))
        rho_ref = ref_admm.adapt_rho(rho, ref["primal"], ref["dual"], acfg.mu, acfg.tau_inc, acfg.tau_dec)
        rho_miss = sum(np.float32(m.rho[k]) != rho_ref[k] for k in LEAVES)
        rho_miss += sum(not np.array_equal(r, rank_rho[0]) for r in rank_rho)
        return dict(z_gap=z_gap, u_gap=u_gap, residual_gap=residual_gap, rho_miss=float(rho_miss))

    def post_round_steps(self) -> dict:
        """The program's side of each block's steps after the first round:
        its state gathered to the host first, then its losses, its first
        gradient (from the first moment's change on the rows it moved) and
        its change over the steps."""
        m, n = self.master, self.n_rows
        state = {kind: [{k: v[:r].to("cpu", copy=True) for k, v in b.items()} for b, r in zip(m.gather_blocks(kind), n)]
                 for kind in ROWS}
        state.update({kind: [{k: v.to("cpu", copy=True) for k, v in b.items()} for b in m.gather_blocks(kind)]
                      for kind in MASK})
        start, rho = m.step, dict(m.rho)
        losses, grads = [[] for _ in n], None
        for i in range(self.traffic["post_round_steps"]):
            for k, metrics in enumerate(m.train_step()):
                losses[k].append(float(metrics["loss"]))
            if i == 0:
                grads = [compare.norms(first_gradient({k: v[:r] for k, v in mu.items()}, mu0))
                         for mu, mu0, r in zip(m.gather_blocks("mu"), state["mu"], n)]
        change = [compare.norms({k: x[k][:r] - x0[k].to(x[k].device) for k in LEAVES})
                  for x, x0, r in zip(m.gather_blocks("params"), state["params"], n)]
        return dict(state=state, start=start, rho=rho, losses=losses, grad=grads, change=change)

    def window(self, seconds: float, tracer=None) -> dict:
        m = self.master
        interval = m.admm_cfg.consensus_interval
        steps, profiled, traced_s = 0, 0, 0.0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 - traced_s < seconds:
            if tracer is not None and not profiled and time.perf_counter() - t0 >= seconds / 2:
                k0 = time.perf_counter()
                with tracer.segment():
                    m.train_iteration()
                profiled = interval
                traced_s = time.perf_counter() - k0
                continue
            m.train_iteration()
            steps += interval
        if tracer is not None and not profiled:  # a window shorter than two intervals
            with tracer.segment():
                m.train_iteration()
            profiled = interval
        m.sync()
        t1 = time.perf_counter()
        total = steps + profiled
        if tracer is not None:
            tracer.spans["admm_round_s"] = self.timed_rounds(interval)
        return dict(e2e=dict(train_step_ms=1e3 * (t1 - t0) / total), attempted=total, failed=0, t0=t0)

    def timed_rounds(self, interval: int) -> list[float]:
        """Host seconds of rounds, each from every rank drained to the
        residuals on rank 0's host."""
        m, out = self.master, []
        for _ in range(self.traffic["timed_rounds"]):
            for _ in range(interval):
                m.train_step()
            m.sync()
            t = time.perf_counter()
            m.consensus()
            out.append(time.perf_counter() - t)
        return out

    def count(self, tracer) -> None:
        tracer.counts["admm_round_bytes"] = admm_counts.round_bytes(self.n_shared,
                                                                    admm_counts.row_floats(self.cfg["max_sh_degree"]))
        tracer.counts["admm_ranks"] = self.ranks
        tracer.counts["admm_rounds_profiled"] = 1

    def verify(self) -> dict:
        """Each block's checked steps against the plain reference (with more
        than one card, block k in a process of its own on card k mod the
        cards, while this process runs the steps after the round block by
        block), then the first round's readings; the ranks are stopped
        first. The training readings are the worst over blocks and over
        both checked segments; `penalty_gap` is the first step after the
        round's loss gap in units of the reference's penalty."""
        cfg, traffic = self.cfg, self.traffic
        self.master.close()
        del self.master
        program.free(self.device)
        interval, post = cfg["consensus_interval"], traffic["post_round_steps"]
        order = ref_admm.camera_orders(cfg["seed"], [len(p) for p in self.poses], interval + post)
        cards = torch.cuda.device_count() if self.device.type == "cuda" else 0
        jobs = [(str(torch.device("cuda", kb % cards) if cards > 1 else self.device), cfg, traffic, self.seed, ids,
                 [self.poses[kb][row[kb]] for row in order[:traffic["check_steps"]]],
                 [self.gts[kb][row[kb]].cpu() for row in order[:traffic["check_steps"]]],
                 [row[kb] for row in order[:traffic["check_steps"]]], len(self.poses[kb]))
                for kb, ids in enumerate(self.ids)]
        if cards > 1:
            ctx = multiprocessing.get_context("spawn")
            with concurrent.futures.ProcessPoolExecutor(len(jobs), mp_context=ctx, initializer=torch.set_num_threads,
                                                        initargs=(1,)) as pool:
                pending = pool.map(reference_block, *zip(*jobs))
                after = self.reference_after_round(order[interval:])
                refs = list(pending)
        else:
            refs = [reference_block(*job) for job in jobs]
            after = self.reference_after_round(order[interval:])
        keys = ("losses", "grad", "change")
        readings = [compare.training_readings({key: self.prog[key][kb] for key in keys}, ref)
                    for kb, ref in enumerate(refs)]
        readings += [compare.training_readings({key: self.post[key][kb] for key in keys}, ref)
                     for kb, ref in enumerate(after)]
        out = {k: max(r[k] for r in readings) for k in readings[0]}
        out["penalty_gap"] = max(abs(prog - ref["losses"][0]) / max(abs(ref["penalty"]), 1e-30)
                                 for prog, ref in zip((ls[0] for ls in self.post["losses"]), after))
        out.update(self.round_readings)
        return out

    def reference_after_round(self, order: list) -> list:
        """Each block's steps after the first round by the plain reference
        on this process's device, from the block's state gathered after the
        round: the losses, the first step's penalty, the first gradient's
        and the change's norms."""
        cfg, post, dev = self.cfg, self.post, self.device
        out = []
        for kb, n in enumerate(self.n_rows):
            on = {kind: {k: v.to(dev) for k, v in post["state"][kind][kb].items()} for kind in ROWS + MASK}
            warm = ref_admm.Warm(mu=on["mu"], nu=on["nu"], mask=nested(on["mask_params"]),
                                 mask_mu=leaf_keys(on["mask_mu"]), mask_nu=leaf_keys(on["mask_nu"]))
            rows = order[: self.traffic["post_round_steps"]]
            r = ref_admm.follow(on["params"], torch.ones((n,), dtype=torch.bool, device=dev),
                                [scenes.view(self.poses[kb][row[kb]], dev) for row in rows],
                                [self.gts[kb][row[kb]].to(dev) for row in rows], [row[kb] for row in rows], cfg,
                                cfg["max_sh_degree"], self.traffic["spatial_lr_scale"], post["start"], on["u"],
                                on["z_local"], post["rho"], len(self.poses[kb]), warm=warm)
            out.append(dict(losses=r["losses"], penalty=r["penalties"][0], grad=compare.norms(r["first_grad"]),
                            change=compare.norms({k: r["params"][k] - on["params"][k] for k in LEAVES})))
            del on, warm, r
            program.free(dev)
        return out


def first_gradient(mu: dict, mu0: dict) -> dict:
    """The gradient a sparse Adam step took, from its first moment before
    (`mu0`, moved to `mu`'s device) and after (`mu`): (mu - 0.9 mu0) / 0.1
    on the rows it moved, 0 elsewhere."""
    out = {}
    for k, m in mu.items():
        before = mu0[k].to(m.device)
        moved = (m != before).reshape(m.shape[0], -1).any(1).view((-1,) + (1,) * (m.dim() - 1))
        out[k] = torch.where(moved, (m.double() - (0.9 * before).double()) / 0.1, 0.0)
    return out


def leaf_keys(flat: dict) -> dict:
    """The program's mask paths (`['conv_in']/['w']`) as the reference's
    leaf keys (`conv_in/w`)."""
    return {k.replace("['", "").replace("']", ""): v for k, v in flat.items()}


def nested(flat: dict) -> dict:
    """The program's flat mask parameters as the reference's nested tree."""
    out: dict = {}
    for key, v in leaf_keys(flat).items():
        *parents, name = key.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = v.clone().requires_grad_(True)
    return out


def reference_block(device: str, cfg: dict, traffic: dict, seed: int, ids, poses: list, gts: list, indices: list,
                    n_images: int) -> dict:
    """One block's checked steps by the plain reference on `device`, from
    its rows of the global model drawn again from the seed: the losses,
    the first gradient's and the change's norms."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    leaves = grid_scene(traffic["n_global"], seed, GLOBAL, dev, traffic, traffic["sh_rest"])
    sel = torch.as_tensor(ids, dtype=torch.int64, device=dev)
    p0 = {k: leaves[k][sel] for k in LEAVES}
    del leaves
    zero = {k: torch.zeros_like(v) for k, v in p0.items()}
    r = ref_admm.follow(p0, torch.ones((len(sel),), dtype=torch.bool, device=dev),
                        [scenes.view(p, dev) for p in poses], [g.to(dev) for g in gts], indices, cfg,
                        cfg["max_sh_degree"], traffic["spatial_lr_scale"], cfg["admm_start_step"], zero, p0,
                        ref_admm.initial_rho(cfg, traffic["n_global"]), n_images)
    return dict(losses=r["losses"], grad=compare.norms(r["first_grad"]),
                change=compare.norms({k: r["params"][k] - p0[k] for k in p0}))


def build(cfg: dict, traffic: dict, seed: int, device, meter) -> AdmmRun:
    return AdmmRun(cfg, traffic, seed, device, meter)
