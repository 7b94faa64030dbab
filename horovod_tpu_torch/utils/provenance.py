"""The provenance block of durable artifacts, the port's copy of what
``horovod_tpu/utils/provenance.py`` gives the history plane's run
manifest: ``git_sha``, ``config_fingerprint`` and ``provenance_stamp``.

The device fields come from torch: ``device_kind`` is
``torch.cuda.get_device_name()`` and ``device_count``
``torch.cuda.device_count()`` on the card; ``platform`` is ``"gpu"``
there, and ``"cpu"`` where the job was initialized on the CPU
(``init(device="cpu")``) or torch sees no card. Every field is
best-effort: a stamp never kills the artifact it describes (no git
binary, no card, an unreprable config each leave their field absent).
"""

import hashlib
import os
import subprocess

from . import metrics as hvd_metrics

PROVENANCE_FIELDS = ("unix_ms", "device_kind", "device_count",
                     "platform", "git_sha", "config_fingerprint",
                     "mesh", "label")


def git_sha(cwd=None):
    """Short git sha of the checkout containing ``cwd`` (default: this
    repo), or None outside a checkout / without a git binary."""
    if cwd is None:
        cwd = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
    try:
        sha = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], cwd=cwd,
            capture_output=True, text=True, timeout=10).stdout.strip()
        return sha or None
    except Exception:  # noqa: BLE001 — provenance is best-effort
        return None


def config_fingerprint(cfg):
    """Truncated sha256 of ``repr(cfg)`` — a config identity, not a
    secret. The dataclass repr carries every field incl. overrides, so
    two runs fingerprint equal iff their configs were equal."""
    return hashlib.sha256(repr(cfg).encode()).hexdigest()[:12]


def provenance_stamp(device_count=None, config=None, label=None,
                     mesh=None, git_cwd=None):
    """The shared provenance block: git sha, device kind/count,
    platform, config fingerprint, wall-clock ms and an optional run
    label (``HVD_BENCH_LABEL`` / ``HVD_RUN_LABEL`` when ``label`` is
    None), plus the mesh layout ({axis: size}) when the caller has one.
    Pure dict of JSON scalars; absent fields are omitted, never None."""
    prov = {"unix_ms": hvd_metrics.shared_clock().epoch_us() // 1000}
    try:
        import torch
        from ..common import state
        device = state.global_state().device
        if (device is not None and device.type == "cpu") or \
                not torch.cuda.is_available():
            prov["device_kind"] = "cpu"
            prov["platform"] = "cpu"
            prov["device_count"] = (1 if device_count is None
                                    else int(device_count))
        else:
            prov["device_kind"] = torch.cuda.get_device_name()
            prov["platform"] = "gpu"
            prov["device_count"] = (torch.cuda.device_count()
                                    if device_count is None
                                    else int(device_count))
    except Exception:  # noqa: BLE001 — provenance is best-effort
        if device_count is not None:
            prov["device_count"] = int(device_count)
    sha = git_sha(cwd=git_cwd)
    if sha:
        prov["git_sha"] = sha
    if config is not None:
        try:
            prov["config_fingerprint"] = config_fingerprint(config)
        except Exception:  # noqa: BLE001 — provenance is best-effort
            pass
    if mesh:
        try:
            prov["mesh"] = {str(k): int(v) for k, v in dict(mesh).items()}
        except Exception:  # noqa: BLE001 — provenance is best-effort
            pass
    if label is None:
        label = os.environ.get("HVD_RUN_LABEL") or \
            os.environ.get("HVD_BENCH_LABEL")
    if label:
        prov["label"] = str(label)
    return prov
