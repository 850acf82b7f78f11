"""What the ported rel-pass probe tools (``bench_rel_steps``,
``bench_rel_pipeline``, ``bench_rel_probe``, ``bench_rel_int4``) share:
the geometry, the device, the features, and the leg runner that checks a
leg against its plain version and then times it."""

from __future__ import annotations

import subprocess

import numpy as np
import torch

from tspn_tpu_torch.runtime import timing

D = 3072   # rel row width: the relative features, 3000 padded to 3072
R = 132    # VidVRD predicates; the JAX tools pad to 256 lanes (RP)
RP = 256   # width of the JAX tools' weight draw, kept for their RandomState sequence
PAIRS_PER_SEGMENT = 32 * 31
NUM_SEGMENTS = 96  # 95,232 rows


def device(arg: str, tool: str) -> torch.device:
    """The tool's device; a CUDA device that is absent raises SystemExit."""
    dev = torch.device(arg)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{tool}: no CUDA device (use --device cpu to run the plain versions)")
    return dev


def device_name(dev: torch.device) -> str:
    """The card's name and power limit (as nvidia-smi reads it), which
    every time it measures stands beside; on the CPU, the host clock."""
    if dev.type != "cuda":
        return "cpu (host clock)"
    index = torch.cuda.current_device() if dev.index is None else dev.index
    limit = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip() or "not read"
    return f"{torch.cuda.get_device_name(dev)}, power limit {limit}"


def features(p: int, dev: torch.device) -> tuple:
    """int8 rows (P, D) uniform in [0, 127] and a (P, 16) f32 sidecar
    uniform in [1e-4, 0.0101): the JAX tools' distributions (``bits &
    0x7F``; ``uniform * 0.01 + 1e-4``), from device generators seeded 1
    and 2 as their PRNG keys are (the same law, not the same bits)."""
    gx = torch.Generator(device=dev).manual_seed(1)
    gs = torch.Generator(device=dev).manual_seed(2)
    x = torch.randint(0, 128, (p, D), generator=gx, device=dev, dtype=torch.int8)
    s = torch.rand((p, 16), generator=gs, device=dev) * 0.01 + 1e-4
    return x, s


def weights_t(w8: np.ndarray, dev: torch.device) -> torch.Tensor:
    """The first R columns of a (D, RP) draw, K-major: (R, D) int8."""
    return torch.as_tensor(np.ascontiguousarray(w8[:, :R].T), device=dev)


class Legs:
    """Runs legs in order: each leg's first call is held ``torch.equal`` to
    its plain version (raising otherwise), then it is timed with
    ``timing.median_ms`` and its bound computed with ``timing.bound``."""

    def __init__(self, dev: torch.device, rows: int):
        self.dev, self.rows, self.legs = dev, rows, {}

    def run(self, label: str, kernel, fn, ref, operands, ops: float, kind: str = "int8",
            feature_bytes: float = None) -> dict:
        """``kernel`` names the launch count the leg moves (None for a
        library leg); ``ops`` 0 bounds the leg by bytes alone;
        ``feature_bytes`` adds the feature stream's GB/s to the line."""
        out = fn()
        want = ref()
        if out.shape != want.shape or not torch.equal(out, want):
            diff = (out.double() - want.double()).abs().max().item() if out.shape == want.shape \
                else f"shape {tuple(out.shape)} vs {tuple(want.shape)}"
            raise AssertionError(f"{label}: result != plain version (max |d| {diff})")
        del want
        ms = timing.median_ms(fn, self.dev)
        entry = {"kernel": kernel, "ms": ms, "mpairs_per_s": self.rows / ms / 1e3,
                 "equal": True, **timing.bound(operands, out, ops, kind)}
        line = f"{label:14s} {ms:9.4f} ms  {entry['mpairs_per_s']:9.3f} Mpairs/s"
        if feature_bytes is not None:
            entry["feature_gb_per_s"] = feature_bytes / ms / 1e6
            line += f"  {entry['feature_gb_per_s']:8.1f} GB/s feat"
        line += f"  bound {entry['bound_ms']:.4f} ms ({entry['bound_by']})"
        print(line, flush=True)
        self.legs[label] = entry
        return entry
