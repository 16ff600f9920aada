"""Run tracking: record a script invocation so it can be reproduced (port
of `utils/tracking.py`, writing the same files).

The analog of the reference's MLflow hooks
(`modelopt/torch/utils/mlflow.py:16`): every tracked run writes a
self-contained local run directory (invocation, config, metrics, artifacts,
outcome) and, when the optional ``mlflow`` package is importable and a
tracking URI is given, mirrors the same record to the server. The local
record is the primary artifact; the mlflow branch is a thin passthrough,
imported only when enabled, as the reference's.

Secrets never land in the record: parameter names matching token/key/
password patterns and URI userinfo are redacted before anything is written
(reference `_redact`).
"""

from __future__ import annotations

import json
import os
import re
import sys
import time
from typing import Any, Optional

_SECRET_NAME = re.compile(
    r"token|api[-_]?key|password|passwd|secret|credential", re.IGNORECASE)
_URI_USERINFO = re.compile(r"(?<=://)[^/\s@]+(?=@)")
_MASK = "***"


def _redact(key: str, value: Any) -> Any:
    if _SECRET_NAME.search(str(key)):
        return _MASK
    if isinstance(value, str):
        return _URI_USERINFO.sub(_MASK, value)
    return value


class RunLogger:
    """Record one script run: params, step metrics, artifacts, outcome.

    Usage::

        with RunLogger("/runs", name="llm_ptq") as run:
            run.log_params(vars(args))
            run.log_metric("ppl", 3.21, step=0)
            run.log_artifact("/tmp/out/hf_quant_config.json")

    The run directory holds ``meta.json`` (invocation + params + outcome),
    ``metrics.jsonl`` (one line per log_metric call) and ``artifacts/``.
    """

    def __init__(self, root: str, name: str = "run",
                 mlflow_uri: Optional[str] = None):
        stamp = time.strftime("%Y%m%d-%H%M%S")
        self.dir = os.path.join(root, f"{name}-{stamp}-{os.getpid()}")
        os.makedirs(os.path.join(self.dir, "artifacts"), exist_ok=True)
        self._meta: dict[str, Any] = {
            "name": name,
            "argv": [_redact("argv", a) for a in sys.argv],
            "cwd": os.getcwd(),
            "start_time": time.time(),
            "params": {},
            "status": "running",
        }
        self._metrics_f = open(os.path.join(self.dir, "metrics.jsonl"), "a")
        self._mlflow = None
        if mlflow_uri is not None:
            try:  # optional dependency, imported only when enabled
                import mlflow  # type: ignore

                # the LIVE connection needs real credentials; only the
                # stored record is redacted
                mlflow.set_tracking_uri(mlflow_uri)
                mlflow.start_run(run_name=name)
                self._mlflow = mlflow
            except ImportError:
                pass
        self._flush_meta()

    # -- recording -----------------------------------------------------
    def log_params(self, params: dict) -> None:
        clean = {k: _redact(k, v) for k, v in params.items()}
        self._meta["params"].update(
            {k: v if isinstance(v, (int, float, str, bool, type(None)))
             else repr(v) for k, v in clean.items()})
        self._flush_meta()
        if self._mlflow:
            self._mlflow.log_params(clean)

    def log_metric(self, key: str, value: float, step: int = 0) -> None:
        rec = {"key": key, "value": float(value), "step": int(step),
               "time": time.time()}
        self._metrics_f.write(json.dumps(rec) + "\n")
        self._metrics_f.flush()
        if self._mlflow:
            self._mlflow.log_metric(key, float(value), step=step)

    def log_artifact(self, path: str) -> None:
        import shutil

        dst = os.path.join(self.dir, "artifacts", os.path.basename(path))
        shutil.copy2(path, dst)
        if self._mlflow:
            self._mlflow.log_artifact(path)

    # -- lifecycle -----------------------------------------------------
    def finish(self, status: str = "finished") -> None:
        self._meta["status"] = status
        self._meta["end_time"] = time.time()
        self._flush_meta()
        self._metrics_f.close()
        if self._mlflow:
            self._mlflow.end_run(status="FINISHED" if status == "finished"
                                 else "FAILED")
            self._mlflow = None

    def __enter__(self) -> "RunLogger":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.finish("finished" if exc_type is None else "failed")

    def _flush_meta(self) -> None:
        with open(os.path.join(self.dir, "meta.json"), "w") as f:
            json.dump(self._meta, f, indent=2)


def read_metrics(run_dir: str) -> list[dict]:
    """Load a run's metrics.jsonl back (for tests / report tooling)."""
    out = []
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        for line in f:
            out.append(json.loads(line))
    return out
