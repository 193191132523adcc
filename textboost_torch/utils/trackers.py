"""Experiment trackers: tensorboard / wandb / comet_ml behind one surface.

A copy of textboost_tpu/utils/trackers.py.  Counterpart of the reference's
Accelerate tracker wiring (train_textboost.py:267-274,941-945: `--report_to`
tensorboard|wandb|comet_ml|all, scalars via accelerator.log, validation
image grids via tracker-specific image APIs).  Every backend is
import-gated so zero-egress environments degrade to whatever is installed.
"""
from __future__ import annotations

import logging
from typing import Dict, Optional, Sequence

import numpy as np

logger = logging.getLogger("textboost")

_KNOWN = ("tensorboard", "wandb", "comet_ml")


class Trackers:
    def __init__(
        self,
        report_to: Optional[str],
        log_dir: str,
        run_name: str = "textboost",
        config: Optional[Dict] = None,
    ):
        self._tb = None
        self._wandb = None
        self._comet = None
        wanted = []
        if report_to in _KNOWN:
            wanted = [report_to]
        elif report_to == "all":
            wanted = list(_KNOWN)
        elif report_to not in (None, "none", "jsonl"):
            logger.info("Unknown report_to=%s; JSONL only", report_to)

        if "tensorboard" in wanted:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir)
            except Exception as e:  # noqa: BLE001 — tracker is best-effort
                logger.info("tensorboard unavailable (%s)", e)
        if "wandb" in wanted:
            try:
                import wandb

                self._wandb = wandb.init(
                    project=run_name, dir=log_dir, config=config or {}
                )
            except Exception as e:  # noqa: BLE001
                logger.info("wandb unavailable (%s)", e)
        if "comet_ml" in wanted:
            try:
                import comet_ml

                self._comet = comet_ml.Experiment(project_name=run_name)
                if config:
                    self._comet.log_parameters(config)
            except Exception as e:  # noqa: BLE001
                logger.info("comet_ml unavailable (%s)", e)

    @property
    def active(self) -> bool:
        return any(t is not None for t in (self._tb, self._wandb, self._comet))

    def log(self, scalars: Dict[str, float], step: int) -> None:
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, v, step)
        if self._wandb is not None:
            self._wandb.log(dict(scalars), step=step)
        if self._comet is not None:
            self._comet.log_metrics(dict(scalars), step=step)

    def log_images(
        self,
        tag: str,
        images: Sequence[np.ndarray],  # each [H, W, 3] uint8
        step: int,
        captions: Optional[Sequence[str]] = None,
    ) -> None:
        if self._tb is not None:
            stacked = np.stack(images).transpose(0, 3, 1, 2)  # NCHW
            self._tb.add_images(tag, stacked, step, dataformats="NCHW")
        if self._wandb is not None:
            import wandb

            self._wandb.log(
                {
                    tag: [
                        wandb.Image(
                            img,
                            caption=captions[i] if captions else None,
                        )
                        for i, img in enumerate(images)
                    ]
                },
                step=step,
            )
        if self._comet is not None:
            for i, img in enumerate(images):
                self._comet.log_image(
                    img,
                    name=f"{tag}_{i}",
                    step=step,
                )

    def finish(self) -> None:
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()
        if self._comet is not None:
            self._comet.end()
