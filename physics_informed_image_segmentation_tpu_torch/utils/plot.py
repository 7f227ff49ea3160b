"""Training-curve plots from the per-epoch metric CSVs.

Counterpart of ``physics_informed_image_segmentation_tpu/utils/plot.py``:
the same public functions, CSV inputs and output file names.  CSVs are
read with the standard library and matplotlib is imported inside the
functions, so importing this module needs neither matplotlib nor pandas.
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Optional, Sequence

__all__ = [
    "plot_training_curves",
    "plot_combined_stage_loss",
    "plot_two_stage_comparison",
    "plot_all_metrics",
    "plot_training_results",
]

_COLORS = {"train": "#2E86AB", "val": "#A23B72", "dice": "#06A77D", "pde": "#F18F01"}


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _read_csv(path: Path) -> dict:
    """Columns of a metric CSV as lists of floats."""
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    cols = rows[0].keys() if rows else []
    return {c: [float(r[c]) for r in rows] for c in cols}


def _finish(fig, output_path: Path, show_plot: bool, what: str) -> None:
    plt = _plt()
    fig.tight_layout()
    output_path = Path(output_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(output_path, dpi=300, bbox_inches="tight")
    print(f"{what} saved to: {output_path}")
    if show_plot:
        plt.show()
    else:
        plt.close(fig)


def _line_panel(ax, df, series: Sequence[tuple[str, str, dict]], title: str, ylabel: str):
    """Plot a list of (column, label, style kwargs) from df on ax."""
    for col, label, style in series:
        style = dict(style)
        if col in df and (not style.pop("skip_if_zero", False) or sum(df[col]) > 0):
            ax.plot(df["epoch"], df[col], label=label, linewidth=2, **style)
    ax.set_xlabel("Epoch", fontsize=11)
    ax.set_ylabel(ylabel, fontsize=11)
    ax.set_title(title, fontsize=12, fontweight="bold")
    ax.legend()
    ax.grid(True, alpha=0.3)


def plot_training_curves(csv_path: Path, output_path: Optional[Path] = None,
                         show_plot: bool = False):
    """2×2 grid: total loss, val Dice, train/val loss components."""
    plt = _plt()
    csv_path = Path(csv_path)
    df = _read_csv(csv_path)
    if output_path is None:
        output_path = csv_path.parent / f"{csv_path.stem}_curves.png"

    fig, axes = plt.subplots(2, 2, figsize=(14, 10))
    fig.suptitle(f"Training Curves: {csv_path.stem}", fontsize=16, fontweight="bold")
    _line_panel(
        axes[0, 0], df,
        [("train_loss", "Train Loss", {"color": _COLORS["train"]}),
         ("val_loss", "Val Loss", {"color": _COLORS["val"]})],
        "Total Loss", "Loss",
    )
    _line_panel(
        axes[0, 1], df,
        [("val_dice_score", "Val Dice Score",
          {"color": _COLORS["dice"], "marker": "o", "markersize": 4})],
        "Validation Dice Score", "Dice Score",
    )
    axes[0, 1].set_ylim([0, 1])
    for ax, prefix, name in ((axes[1, 0], "train", "Training"), (axes[1, 1], "val", "Validation")):
        _line_panel(
            ax, df,
            [(f"{prefix}_dice_loss", "Dice Loss", {"linestyle": "--", "alpha": 0.8}),
             (f"{prefix}_bce_loss", "BCE Loss", {"linestyle": "--", "alpha": 0.8}),
             (f"{prefix}_pde_loss", "PDE Loss",
              {"linestyle": "--", "alpha": 0.8, "color": _COLORS["pde"], "skip_if_zero": True}),
             (f"{prefix}_phase_field_loss", "Phase-Field Loss",
              {"linestyle": "--", "alpha": 0.8, "skip_if_zero": True})],
            f"{name} Loss Components", "Loss",
        )
    _finish(fig, output_path, show_plot, "Training curves")


def plot_combined_stage_loss(csv_path_stage1: Path, csv_path_stage2: Path,
                             output_path: Optional[Path] = None, show_plot: bool = False):
    """Stage I + Stage II loss on one epoch axis with a transition marker."""
    plt = _plt()
    csv_path_stage1, csv_path_stage2 = Path(csv_path_stage1), Path(csv_path_stage2)
    df1, df2 = _read_csv(csv_path_stage1), _read_csv(csv_path_stage2)
    if output_path is None:
        stem = csv_path_stage1.stem
        timestamp = stem.split("_")[-1] if "_" in stem else "combined"
        output_path = csv_path_stage1.parent / f"combined_loss_{timestamp}.png"

    transition = len(df1["epoch"])
    e1 = df1["epoch"]
    e2 = [e + transition for e in df2["epoch"]]
    fig, ax = plt.subplots(figsize=(12, 7))
    ax.plot(e1, df1["train_loss"], label="Stage I Train", linewidth=2, color=_COLORS["train"])
    ax.plot(e1, df1["val_loss"], label="Stage I Val", linewidth=2, color=_COLORS["val"])
    ax.plot(e2, df2["train_loss"], label="Stage II Train", linewidth=2,
            color=_COLORS["train"], linestyle="--")
    ax.plot(e2, df2["val_loss"], label="Stage II Val", linewidth=2,
            color=_COLORS["val"], linestyle="--")
    ax.axvline(transition + 0.5, color="gray", linestyle=":", linewidth=2,
               label="Stage I → II transition")
    ax.set_xlabel("Epoch (continuous)", fontsize=11)
    ax.set_ylabel("Loss", fontsize=11)
    ax.set_title("Two-Stage Training Loss", fontsize=14, fontweight="bold")
    ax.legend()
    ax.grid(True, alpha=0.3)
    _finish(fig, output_path, show_plot, "Combined stage loss plot")


def plot_two_stage_comparison(csv_path_stage1: Path, csv_path_stage2: Path,
                              output_path: Optional[Path] = None, show_plot: bool = False):
    """Side-by-side stage curves + best-val-Dice bar chart."""
    plt = _plt()
    csv_path_stage1, csv_path_stage2 = Path(csv_path_stage1), Path(csv_path_stage2)
    df1, df2 = _read_csv(csv_path_stage1), _read_csv(csv_path_stage2)
    if output_path is None:
        output_path = csv_path_stage1.parent / "two_stage_comparison.png"

    fig, axes = plt.subplots(1, 3, figsize=(18, 5))
    for df, label, color in ((df1, "Stage I", _COLORS["train"]),
                             (df2, "Stage II", _COLORS["pde"])):
        axes[0].plot(df["epoch"], df["val_loss"], label=label, linewidth=2, color=color)
        axes[1].plot(df["epoch"], df["val_dice_score"], label=label, linewidth=2, color=color)
    axes[0].set_title("Validation Loss", fontweight="bold")
    axes[1].set_title("Validation Dice Score", fontweight="bold")
    axes[1].set_ylim([0, 1])
    for ax in axes[:2]:
        ax.set_xlabel("Epoch")
        ax.legend()
        ax.grid(True, alpha=0.3)

    best = [max(df1["val_dice_score"]), max(df2["val_dice_score"])]
    bars = axes[2].bar(["Stage I\n(Baseline)", "Stage II\n(PDE)"], best,
                       color=[_COLORS["train"], _COLORS["pde"]])
    for bar, v in zip(bars, best):
        axes[2].text(bar.get_x() + bar.get_width() / 2, v + 0.01, f"{v:.4f}",
                     ha="center", fontweight="bold")
    axes[2].set_ylim([0, 1.05])
    axes[2].set_title("Best Validation Dice", fontweight="bold")
    axes[2].grid(True, alpha=0.3, axis="y")
    _finish(fig, output_path, show_plot, "Two-stage comparison plot")


def plot_all_metrics(csv_path: Path, output_path: Optional[Path] = None,
                     show_plot: bool = False):
    """3×2 grid of every train/val metric in the CSV schema."""
    plt = _plt()
    csv_path = Path(csv_path)
    df = _read_csv(csv_path)
    if output_path is None:
        output_path = csv_path.parent / f"{csv_path.stem}_all_metrics.png"

    fig, axes = plt.subplots(3, 2, figsize=(14, 14))
    fig.suptitle(f"All Metrics: {csv_path.stem}", fontsize=16, fontweight="bold")
    panels = [
        ("Total Loss", "Loss", [("train_loss", "Train", {}), ("val_loss", "Val", {})], None),
        ("Dice Score", "Dice", [("train_dice_score", "Train", {}),
                                ("val_dice_score", "Val", {})], [0, 1]),
        ("IoU Score", "IoU", [("train_iou_score", "Train", {}),
                              ("val_iou_score", "Val", {})], [0, 1]),
        ("Boundary F1", "F1", [("train_boundary_f1_score", "Train", {}),
                               ("val_boundary_f1_score", "Val", {})], [0, 1]),
        ("Dice + BCE Losses", "Loss",
         [("train_dice_loss", "Train Dice", {"linestyle": "--"}),
          ("val_dice_loss", "Val Dice", {"linestyle": "--"}),
          ("train_bce_loss", "Train BCE", {"alpha": 0.7}),
          ("val_bce_loss", "Val BCE", {"alpha": 0.7})], None),
        ("Physics Losses", "Loss",
         [("train_pde_loss", "Train PDE", {"skip_if_zero": True}),
          ("val_pde_loss", "Val PDE", {"skip_if_zero": True}),
          ("train_phase_field_loss", "Train PF", {"skip_if_zero": True}),
          ("val_phase_field_loss", "Val PF", {"skip_if_zero": True})], None),
    ]
    for ax, (title, ylabel, series, ylim) in zip(axes.flat, panels):
        _line_panel(ax, df, series, title, ylabel)
        if ylim:
            ax.set_ylim(ylim)
    _finish(fig, output_path, show_plot, "All-metrics plot")


def plot_training_results(csv_path_stage1: Path, csv_path_stage2: Optional[Path] = None,
                          output_dir: Optional[Path] = None, show_plots: bool = False):
    """Per-stage curves and metric grids, plus the combined-loss and
    stage-comparison figures when Stage II exists."""
    csv_path_stage1 = Path(csv_path_stage1)
    output_dir = Path(output_dir) if output_dir is not None else csv_path_stage1.parent
    stages = [csv_path_stage1] + ([Path(csv_path_stage2)] if csv_path_stage2 else [])
    for path in stages:
        plot_training_curves(path, output_dir / f"{path.stem}_curves.png", show_plots)
        plot_all_metrics(path, output_dir / f"{path.stem}_all_metrics.png", show_plots)
    if csv_path_stage2 is not None:
        plot_combined_stage_loss(csv_path_stage1, csv_path_stage2,
                                 output_dir / "combined_loss_stage1_stage2.png", show_plots)
        plot_two_stage_comparison(csv_path_stage1, csv_path_stage2,
                                  output_dir / "two_stage_comparison.png", show_plots)
