"""Package LPIPS(vgg) weights into the single file `eval.metrics.LPIPSVgg` loads
(counterpart of gaustar_tpu/eval/lpips_convert.py; the same file format, so a
file packed by either package loads in both).

The reference scores LPIPS with the `lpips` pip package
(gaussian_splatting/metrics.py:36-95, `lpips.LPIPS(net_type='vgg')`), which at
runtime downloads (a) torchvision's pretrained VGG16 and (b) its own learned
linear layer weights. This environment has no egress, so scoring here requires
the two checkpoints to be converted ONCE (on any machine that has them) into a
single self-contained blob:

    python -m gaustar_tpu_torch.eval.lpips_convert vgg16.pth lpips_vgg.pth out.pt

Accepted input layouts:
  vgg16.pth   torchvision vgg16 state dict — full model keys
              ('features.0.weight', ..., 'classifier.*' ignored) or the bare
              'features' trunk ('0.weight', ...).
  lpips.pth   the lpips-package vgg checkpoint: keys 'lin{i}.model.1.weight'
              (shape [1, C, 1, 1]) for i in 0..4, or already-flat 'lins'.

Output: torch-serialized dict {'features.N.weight'/'features.N.bias': ...,
'lins': [w0..w4 as [C] vectors]} — exactly what LPIPSVgg.__init__ parses.
"""

from __future__ import annotations

import sys

import torch

# Channel counts of the five LPIPS tap points (relu1_2 ... relu5_3 of VGG16).
LIN_CHANNELS = [64, 128, 256, 512, 512]


def convert(vgg_path: str, lpips_path: str, out_path: str) -> dict:
    vgg = torch.load(vgg_path, map_location="cpu")
    if hasattr(vgg, "state_dict"):
        vgg = vgg.state_dict()
    if "state_dict" in vgg and isinstance(vgg["state_dict"], dict):
        vgg = vgg["state_dict"]

    feats = {k: v for k, v in vgg.items() if k.startswith("features.")}
    if not feats:
        # Bare 'features' trunk: keys are '0.weight', '2.weight', ...
        feats = {
            f"features.{k}": v
            for k, v in vgg.items()
            if k.split(".")[0].isdigit() and k.split(".")[-1] in ("weight", "bias")
        }
    if not feats:
        raise ValueError(f"{vgg_path}: no VGG16 'features' conv weights found")

    lp = torch.load(lpips_path, map_location="cpu")
    if "lins" in lp:
        lins = [torch.as_tensor(w).reshape(-1) for w in lp["lins"]]
    else:
        lins = []
        for i in range(5):
            for key in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight"):
                if key in lp:
                    lins.append(lp[key].reshape(-1))
                    break
            else:
                raise ValueError(f"{lpips_path}: missing linear weight for tap {i}")
    for i, (w, c) in enumerate(zip(lins, LIN_CHANNELS)):
        if w.numel() != c:
            raise ValueError(f"lin{i}: expected {c} weights, got {w.numel()}")

    blob = dict(feats)
    blob["lins"] = lins
    torch.save(blob, out_path)
    return blob


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 3:
        print(__doc__)
        raise SystemExit(2)
    convert(*argv)
    print(f"wrote {argv[2]}")


if __name__ == "__main__":
    main()
