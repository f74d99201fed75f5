"""Training observability: JSON-lines metrics + optional wandb (the port's
copy of ``improving_learned_index_tpu/core/metrics_log.py``: the same lines).

Reference capability (SURVEY.md §5): wandb on rank 0 (project "DeepImpact",
train loss/avg/step/lr/grad-norm, trainer.py:49-50,121-131) and
``metrics.txt`` JSON lines (trainer.py:139-141).  wandb is a gated optional
— absent, everything lands in the JSON-lines file.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional, Union


class MetricsLogger:
    def __init__(
        self,
        log_dir: Union[str, Path],
        use_wandb: bool = False,
        project: str = "DeepImpact",
        config: Optional[Dict[str, Any]] = None,
        filename: str = "metrics.txt",
    ):
        self.path = Path(log_dir) / filename
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._wandb = None
        if use_wandb:
            try:
                import wandb  # gated optional dependency

                wandb.init(project=project, config=config)
                self._wandb = wandb
            except ImportError:
                pass

    def log(self, record: Dict[str, Any], step: Optional[int] = None) -> None:
        payload = dict(record)
        if step is not None:
            payload["step"] = step
        with open(self.path, "a", encoding="utf-8") as f:
            f.write(json.dumps(payload, default=str) + "\n")
        if self._wandb is not None:
            self._wandb.log(record, step=step)

    def finish(self) -> None:
        if self._wandb is not None:
            self._wandb.finish()
