"""Experiment tracking behind an interface — wandb optional, files default.

The reference is hard-wired to wandb for config storage, metric logging,
figure artifacts and artifact-path bookkeeping (SURVEY.md §5; ref
main.py:56-61,225-227). Here a run directory carries the same roles:

  run_dir/
    config.json       — resolved Config (the wandb.config analogue)
    metrics.jsonl     — one JSON object per log() call (scalars + step)
    notes.txt         — freeform notes (wandb run.notes analogue)
    figures/*.png     — saved matplotlib figures
    artifacts.json    — named artifact paths (wandb.config.update analogue)

If wandb is importable and ``use_wandb=True`` the same calls mirror to it.
"""

from __future__ import annotations

import datetime
import json
import os
from typing import Optional

from diffusion_model.config import Config


class RunLogger:
    def __init__(self, run_dir: str, cfg: Optional[Config] = None,
                 project: str = "diffusion_model",
                 run_name: Optional[str] = None, use_wandb: bool = False,
                 notes: Optional[str] = None):
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        os.makedirs(os.path.join(run_dir, "figures"), exist_ok=True)
        self._metrics_path = os.path.join(run_dir, "metrics.jsonl")
        self._artifacts_path = os.path.join(run_dir, "artifacts.json")
        self._wandb = None
        if cfg is not None:
            with open(os.path.join(run_dir, "config.json"), "w") as f:
                json.dump(cfg.to_dict(), f, indent=2)
        if notes:
            with open(os.path.join(run_dir, "notes.txt"), "w") as f:
                f.write(notes + "\n")
        if use_wandb:
            try:
                import wandb  # noqa: PLC0415

                self._wandb = wandb.init(
                    project=project, name=run_name,
                    config=cfg.to_dict() if cfg else None, notes=notes,
                )
            except ImportError:
                pass

    # -- scalars ---------------------------------------------------------
    def log(self, metrics: dict, step: Optional[int] = None) -> None:
        rec = dict(metrics)
        if step is not None:
            rec["step"] = step
        rec["time"] = datetime.datetime.now().isoformat(timespec="seconds")
        with open(self._metrics_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    # -- figures ---------------------------------------------------------
    def log_figure(self, name: str, fig) -> str:
        path = os.path.join(self.run_dir, "figures", f"{name}.png")
        fig.savefig(path, dpi=120, bbox_inches="tight")
        if self._wandb is not None:
            import wandb  # noqa: PLC0415

            self._wandb.log({name: wandb.Image(fig)})
        return path

    # -- artifact registry -------------------------------------------------
    def register_artifact(self, name: str, path: str) -> None:
        data = {}
        if os.path.isfile(self._artifacts_path):
            with open(self._artifacts_path) as f:
                data = json.load(f)
        data[name] = path
        with open(self._artifacts_path, "w") as f:
            json.dump(data, f, indent=2)

    def artifact(self, name: str) -> str:
        with open(self._artifacts_path) as f:
            return json.load(f)[name]

    def finish(self) -> None:
        if self._wandb is not None:
            self._wandb.finish()


def load_run_config(run_dir: str) -> Config:
    """Recover a run's Config (the resume path the reference does through
    ``wandb.init(id=..., resume='must')``, ref main.py:58-61)."""
    from diffusion_model.config import from_dict

    with open(os.path.join(run_dir, "config.json")) as f:
        return from_dict(json.load(f))
