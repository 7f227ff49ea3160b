"""Multi-process runs of the port's parallel package for the CPU tests.

:func:`launch` starts WORLD processes of this file, which join one gloo
group through a ``file://`` store in a test's temporary directory (no TCP
port, so concurrent test workers cannot collide), run one scenario and
write ``out_<rank>.npz`` there.  It kills every worker as soon as one
fails or the time limit passes.  The workers import the port, numpy and
torch only — never JAX.

    python tests/torch_port_dist_worker.py SCENARIO DIR RANK WORLD

Scenarios read their inputs from ``DIR/inputs.npz`` (and, for weights,
``DIR/weights.pt``):

* ``halo``: the halo losses and their gradients on this rank's band;
* ``dp``: data-parallel epochs (``make_sharded_epoch_fns``) and
  ``shard_train_state`` for every optimizer;
* ``step``: the data×space train step with halo physics (K3's plain
  version) at each of two image sizes, and with the plain halo stencils;
* ``spatial``: ``train_stage`` over space-sharded epochs
  (``make_sharded_epoch_fns(spatial=True)``), then one more validation
  pass.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent

# seconds: the store rendezvous and each collective; the whole run
INIT_TIMEOUT = 60
RUN_TIMEOUT = 120


class Workers:
    """``world`` worker processes of one scenario, started at once;
    :meth:`results` waits for them (the caller may work meanwhile)."""

    def __init__(self, scenario: str, workdir: Path, world: int, timeout: float = RUN_TIMEOUT):
        self.scenario, self.workdir = scenario, Path(workdir)
        self.deadline = time.monotonic() + timeout
        env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
        env.pop("JAX_PLATFORMS", None)
        self.logs = [open(self.workdir / f"log_{r}.txt", "w") for r in range(world)]
        self.procs = [
            subprocess.Popen(
                [sys.executable, __file__, scenario, str(self.workdir), str(r), str(world)],
                env=env, stdout=self.logs[r], stderr=subprocess.STDOUT)
            for r in range(world)
        ]

    def results(self) -> list[dict]:
        """Each rank's outputs; kills every worker and raises with their
        logs as soon as one fails or the time limit passes."""
        procs = self.procs
        try:
            while any(p.poll() is None for p in procs):
                if (any(p.returncode not in (None, 0) for p in procs)
                        or time.monotonic() > self.deadline):
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            for f in self.logs:
                f.close()
        bad = [r for r, p in enumerate(procs) if p.returncode != 0]
        if bad:
            text = "\n".join(f"--- rank {r} (exit {procs[r].returncode}) ---\n"
                             + (self.workdir / f"log_{r}.txt").read_text()[-4000:] for r in bad)
            raise RuntimeError(f"{self.scenario}: ranks {bad} failed\n{text}")
        return [dict(np.load(self.workdir / f"out_{r}.npz")) for r in range(len(procs))]


def launch(scenario: str, workdir: Path, world: int, timeout: float = RUN_TIMEOUT) -> list[dict]:
    """Run ``scenario`` on ``world`` gloo processes; returns each rank's outputs."""
    return Workers(scenario, workdir, world, timeout).results()


# --------------------------------------------------------------------------
# worker side
# --------------------------------------------------------------------------


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _params(model) -> dict:
    return {f"param/{k}": _np(v) for k, v in model.state_dict().items()}


def scenario_halo(inp, torch, P) -> dict:
    """Values and band gradients of the three halo losses."""
    D, a, eps = float(inp["D"]), float(inp["a"]), float(inp["eps"])
    mesh = P.make_mesh(data=int(inp["data"]), space=int(inp["space"]))
    # without batch_axis the batch is not sharded (data is 1): bands of rows only
    batch_axis = P.DATA_AXIS if int(inp["batch_axis"]) else None
    u = P.batch_space_sharding(mesh)(torch.tensor(inp["u"]))
    u = u.contiguous().requires_grad_(True)
    out = {"data_rank": mesh.data_rank, "space_rank": mesh.space_rank}
    rd, pf = P.halo_physics_loss_pallas(u, mesh, D, a, eps, bool(inp["use_reaction"]),
                                        batch_axis=batch_axis)
    out["fused_rd"], out["fused_pf"] = float(rd), float(pf)
    (out["fused_grad"],) = (_np(g) for g in torch.autograd.grad(rd + 0.5 * pf, u))
    if not batch_axis:
        rd = P.halo_residual_loss(u, mesh, D, a)
        pf = P.halo_phase_field_loss(u, mesh, eps)
        out["rd"], out["pf"] = float(rd), float(pf)
        out["rd_grad"] = _np(torch.autograd.grad(rd, u)[0])
        out["pf_grad"] = _np(torch.autograd.grad(pf, u)[0])
    return out


def scenario_dp(inp, torch, P) -> dict:
    """Sharded train and eval epochs: the Stage II objective at dropout 0
    (given weights) and at dropout 0.1 (seeded init), and the Stage I
    objective at dropout 0 (given weights); shard_train_state for each
    optimizer."""
    from physics_informed_image_segmentation_tpu_torch.models import UNet
    from physics_informed_image_segmentation_tpu_torch.train import LossConfig
    from physics_informed_image_segmentation_tpu_torch.train.engine import (
        _OPTIMIZERS,
        create_train_state,
    )

    mesh = P.make_mesh(data=int(inp["world"]))
    stage2 = LossConfig(pde_weight=1e-4, phase_field_weight=1e-4, diffusion_coeff=5.0)
    images, masks = torch.tensor(inp["images"]), torch.tensor(inp["masks"])
    out = {}
    runs = (("d0", 0.0, stage2), ("d1", 0.1, stage2), ("s1", 0.0, LossConfig()))
    for tag, dropout, cfg in runs:
        model = UNet(base_channels=4, dropout=dropout,
                     generator=torch.Generator().manual_seed(int(inp["init_seed"])))
        if dropout == 0.0:
            model.load_state_dict(torch.load(Path(inp["workdir"].item()) / "weights.pt"))
        state = create_train_state(model, float(inp["lr"]), dropout_seed=3)
        state = P.shard_train_state(state, mesh)
        train_fn, eval_fn = P.make_sharded_epoch_fns(cfg, mesh, precision="f32")
        for e in range(int(inp["epochs"])):
            idx, valid = torch.tensor(inp[f"idx{e}"]), torch.tensor(inp[f"valid{e}"])
            state, res = train_fn(state, images, masks, idx, valid)
            for k, v in res.items():
                out[f"{tag}/train{e}/{k}"] = v
        val = eval_fn(model, images, masks, torch.tensor(inp["idx0"]), torch.tensor(inp["valid0"]))
        for k, v in val.items():
            out[f"{tag}/val/{k}"] = v
        out.update({f"{tag}/{k}": v for k, v in _params(model).items()})

    # every optimizer: rank-dependent states become rank 0's
    for name in _OPTIMIZERS:
        rank = mesh.data_rank
        model = UNet(base_channels=2, dropout=0.1,
                     generator=torch.Generator().manual_seed(rank))
        state = create_train_state(model, 1e-3, optimizer=name, dropout_seed=rank + 10)
        g = torch.Generator().manual_seed(100 + rank)
        for _ in range(rank + 1):
            state.optimizer.step([torch.randn(p.shape, generator=g) for p in model.parameters()])
        torch.rand(rank + 1, generator=state.dropout_generator)
        P.shard_train_state(state, mesh)
        opt = state.optimizer.state_dict()
        flat = [p.reshape(-1).float() for p in [*model.parameters(), *opt["m"], *opt["v"]]]
        out[f"opt/{name}/flat"] = _np(torch.cat(flat))
        out[f"opt/{name}/count"] = state.optimizer.count
        out[f"opt/{name}/draw"] = _np(torch.rand(4, generator=state.dropout_generator))
    return out


def scenario_step(inp, torch, P) -> dict:
    """One data×space step with halo physics at each image size, and one
    with the plain halo stencils at the first, from the same weights;
    params after each."""
    from physics_informed_image_segmentation_tpu_torch.models import UNet
    from physics_informed_image_segmentation_tpu_torch.train import LossConfig
    from physics_informed_image_segmentation_tpu_torch.train.engine import create_train_state

    mesh = P.make_mesh(data=int(inp["data"]), space=int(inp["space"]))
    cfg = LossConfig(pde_weight=1e-3, phase_field_weight=1e-4, diffusion_coeff=5.0)
    weights = torch.load(Path(inp["workdir"].item()) / "weights.pt")
    out = {}
    sizes = [int(s) for s in inp["sizes"]]
    for tag, halo, size in [(f"halo{s}", True, s) for s in sizes] + [("plain", False, sizes[0])]:
        x, y = torch.tensor(inp[f"images{size}"]), torch.tensor(inp[f"masks{size}"])
        model = UNet(base_channels=4, dropout=0.0)
        model.load_state_dict(weights)
        state = P.shard_train_state(create_train_state(model, float(inp["lr"])), mesh)
        step = P.make_sharded_train_step(cfg, mesh, spatial=True, halo_physics=halo)
        state, loss = step(state, x, y)
        out[f"{tag}/loss"] = float(loss)
        out.update({f"{tag}/{k}": v for k, v in _params(model).items()})
    return out


def scenario_spatial(inp, torch, P) -> dict:
    """``train_stage`` with space-sharded epochs from the given weights
    (dropout 0), the epoch rows and parameters after it, and a validation
    pass of the trained model."""
    from physics_informed_image_segmentation_tpu_torch.data import DeviceDataset
    from physics_informed_image_segmentation_tpu_torch.models import UNet
    from physics_informed_image_segmentation_tpu_torch.train import LossConfig, engine

    mesh = P.make_mesh(data=int(inp["data"]), space=int(inp["space"]))
    cfg = LossConfig(pde_weight=1e-3, phase_field_weight=1e-4, diffusion_coeff=5.0)
    model = UNet(base_channels=int(inp["base"]), dropout=0.0)
    model.load_state_dict(torch.load(Path(inp["workdir"].item()) / "weights.pt"))
    state = P.shard_train_state(engine.create_train_state(model, float(inp["lr"])), mesh)
    train = DeviceDataset.from_numpy(inp["train_images"], inp["train_masks"], "cpu")
    val = DeviceDataset.from_numpy(inp["val_images"], inp["val_masks"], "cpu")
    train_fn, eval_fn = P.make_sharded_epoch_fns(cfg, mesh, spatial=True)
    state, _, _, rows = engine.train_stage(
        state, train_fn, eval_fn, train, val, batch_size=int(inp["batch"]),
        num_epochs=int(inp["epochs"]), stage_name="spatial", shuffle_seed=int(inp["seed"]),
        verbose=False)
    out = {f"row{e}/{k}": float(v) for e, row in enumerate(rows) for k, v in row.items()}
    val_idx, val_valid = torch.tensor(inp["val_idx"]), torch.tensor(inp["val_valid"])
    res = eval_fn(model, val.images, val.masks, val_idx, val_valid)
    out.update({f"val/{k}": v for k, v in res.items()})
    out.update(_params(model))
    return out


def main(argv) -> int:
    scenario, workdir, rank, world = argv[1], Path(argv[2]), int(argv[3]), int(argv[4])
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    sys.path.insert(0, str(REPO))
    from physics_informed_image_segmentation_tpu_torch import parallel as P

    P.initialize_distributed(f"file://{workdir / 'store'}", world, rank, device="cpu",
                             timeout=INIT_TIMEOUT)
    try:
        inp = dict(np.load(workdir / "inputs.npz"))
        inp["workdir"] = np.array(str(workdir))
        out = {"scenario_halo": scenario_halo, "scenario_dp": scenario_dp,
               "scenario_step": scenario_step,
               "scenario_spatial": scenario_spatial}[f"scenario_{scenario}"](inp, torch, P)
        np.savez(workdir / f"out_{rank}.npz", **out)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
