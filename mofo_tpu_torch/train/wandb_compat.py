"""Optional Weights & Biases sink: the port's copy of
mofo_tpu/train/wandb_compat.py.

The reference logs to wandb with hardcoded project / group names
(run_mae_pretraining.py:250-255, run_class_finetuning.py:543-560). wandb
is not a dependency of the port, so this wrapper does nothing when no
project is named (WANDB_PROJECT in the runners), when the package is
missing or when wandb.init fails (no API key, offline).
"""

from __future__ import annotations

from typing import Dict, Optional


class WandbLogger:
    def __init__(
        self,
        project: Optional[str] = None,
        group: Optional[str] = None,
        name: Optional[str] = None,
        config: Optional[Dict] = None,
        enabled: bool = True,
    ):
        self._run = None
        if not (enabled and project):
            return
        try:
            import wandb

            self._run = wandb.init(
                project=project, group=group, name=name, config=config
            )
        except Exception as exc:  # missing package, no API key, offline
            print(f"[wandb] disabled: {exc}")

    def log(self, data: Dict, step: Optional[int] = None) -> None:
        if self._run is not None:
            self._run.log(data, step=step)

    def finish(self) -> None:
        if self._run is not None:
            self._run.finish()
