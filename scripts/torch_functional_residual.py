"""Which op keeps the port's functional path on the GPU from equalling its
CPU self.

    python scripts/torch_functional_residual.py

Evaluates the steps of the functional Macenko transform
(``extractive.transform``) and the functional Reinhard transform
(``reinhard.transform``) on the CPU and on the card, each step on the same
inputs (the CPU's outputs of the steps before it), on 256 synthetic H&E
tiles of 256x256 from ``tests/synth.py`` (a seed). Prints one line per
step: how many output values differ between the two devices and by how
much; the whole transforms' bytes last. A step whose outputs differ is an
op that rounds differently on the two devices. The last line is a JSON
object with the same figures. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
SEED = 20261016
B, SIDE = 256, 256


def _synth():
    spec = importlib.util.spec_from_file_location(
        "stain_synth", ROOT / "tests" / "synth.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _to(x, dev):
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, tuple) and hasattr(x, "_fields"):  # a NamedTuple
        return type(x)(*(_to(y, dev) for y in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_to(y, dev) for y in x)
    return x


def _diff(a, b):
    """(values, values that differ, max |difference|) of two outputs."""
    if isinstance(a, (tuple, list)):
        parts = [_diff(x, y) for x, y in zip(a, b)]
        return (sum(p[0] for p in parts), sum(p[1] for p in parts),
                max(p[2] for p in parts))
    a, b = a.cpu().double(), b.cpu().double()
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    d = (a - b).abs().nan_to_num(0.0)
    return a.numel(), int((~same).sum()), float(d.max()) if d.numel() else 0.


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_functional_residual: no CUDA device", file=sys.stderr)
        return 2
    from stainlib_tpu_torch.extraction.macenko import stain_matrix_macenko
    from stainlib_tpu_torch.normalization import extractive, reinhard
    from stainlib_tpu_torch.ops.colorspace import (lab_to_rgb, rgb_to_lab,
                                                   rgb_to_od)
    from stainlib_tpu_torch.ops.fdiv import f64
    from stainlib_tpu_torch.ops.lasso import get_concentrations
    from stainlib_tpu_torch.ops.linalg3 import eigh3x3_f64
    from stainlib_tpu_torch.ops.percentile import (masked_percentile,
                                                   mean_std, percentile)
    from stainlib_tpu_torch.ops.tissue import (standardize_brightness,
                                               tissue_mask)

    dev = torch.device("cuda", 0)
    synth = _synth()
    rgb = torch.from_numpy(synth.he_batch(B, SIDE, SIDE, seed=SEED + 1))
    target = torch.from_numpy(synth.he_patch(SIDE, SIDE, seed=SEED))
    steps = []

    def step(name, fn, *args):
        """Run ``fn`` on the CPU and on the card on the same inputs; return
        the CPU's output for the next steps."""
        cpu = fn(*args)
        card = fn(*_to(args, dev))
        steps.append((name, *_diff(cpu, card)))
        return cpu

    # Reinhard, the steps of reinhard.transform (quantize=True).
    rp = reinhard.fit(target)
    x = step("reinhard: standardize_brightness", standardize_brightness,
             rgb.float())
    x = reinhard._quantize_u8(x)
    lab = step("reinhard: rgb_to_lab (uint8: the gamma table)", rgb_to_lab, x)
    lab = step("reinhard: _quantize_lab", reinhard._quantize_lab, lab)
    means, stds = step("reinhard: mean_std", mean_std, lab, (-3, -2))

    def transfer(lab, means, stds, tm, ts):
        scale = ts / torch.clamp_min(stds, 1e-6)
        norm = (lab - means[..., None, None, :]) * scale[..., None, None, :]
        norm = norm + tm[..., None, None, :]
        pscale, shift = reinhard._pack(norm.device)
        packed = torch.floor(torch.clamp(norm * pscale + shift, 0.0, 255.0))
        return (packed - shift) / pscale

    norm = step("reinhard: LAB transfer and uint8 packing", transfer, lab,
                means, stds, rp.means, rp.stds)
    step("reinhard: lab_to_rgb", lab_to_rgb, norm)
    step("reinhard: whole transform (bytes)", reinhard.transform, rp, rgb)

    # Macenko, the steps of extractive.transform.
    mp = extractive.fit(target)
    mask = step("macenko: tissue_mask", lambda r: tissue_mask(r).mask, rgb)
    od = step("macenko: rgb_to_od (uint8: the log table)", rgb_to_od,
              rgb).reshape(B, -1, 3)
    m = mask.reshape(B, -1).float()

    def covariance(od, m):  # extraction/macenko.py's float64 moments
        n = m.sum(-1)
        mean = (torch.einsum("...n,...nc->...c", m.double(), od.double())
                .float() / torch.clamp_min(n, 1.0)[..., None])
        centered = od - mean[..., None, :]
        cov = torch.einsum("...nc,...nd->...cd",
                           (centered * m[..., None]).double(),
                           centered.double()).float()
        return cov / torch.clamp_min(n - 1.0, 1.0)[..., None, None]

    cov = step("macenko: float64 moments -> covariance", covariance, od, m)
    _, V = step("macenko: eigh3x3_f64", eigh3x3_f64, cov)
    V2 = V[..., :, [2, 1]]
    V2 = V2 * torch.where(V2[..., 0:1, :] < 0.0, -1.0, 1.0)
    that = step("macenko: projection einsum (float32)",
                lambda a, b: torch.einsum("...nc,...ck->...nk", a, b), od, V2)
    phi = step("macenko: atan2 (float64)",
               lambda t: f64(torch.atan2, t[..., 1], t[..., 0]), that)
    q = torch.tensor([1.0, 99.0])
    lims = step("macenko: masked_percentile", masked_percentile, phi, m > 0,
                q)
    step("macenko: cos, sin (float64)",
         lambda t: (f64(torch.cos, t), f64(torch.sin, t)), lims)
    M = step("macenko: stain_matrix_macenko (whole)", stain_matrix_macenko,
             rgb)
    C = step("macenko: get_concentrations", get_concentrations, rgb, M)
    C = C.reshape(B, -1, 2)
    mc = step("macenko: percentile", percentile, C, 99.0, -2)
    scaled = C * (mp.max_c_target / torch.clamp_min(mc, 1e-8))[:, None, :]
    step("macenko: reconstruct", extractive.reconstruct, scaled,
         mp.stain_matrix_target)
    step("macenko: whole transform (bytes)", extractive.transform, mp, rgb)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    for name, n, k, mx in steps:
        print(f"{name}: {k} of {n} values differ between the card and the "
              f"CPU (share {k / max(n, 1):.3e}, max |diff| {mx:.6g})",
              flush=True)
    print(json.dumps({"card": smi, "steps": {
        name: dict(values=n, differ=k, max_abs_diff=mx)
        for name, n, k, mx in steps}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
