"""Convert a torchvision VGG16 checkpoint (a ``.pth`` state dict) to the
VGG16 parameters of ``--vgg16_weights``, once, offline (port of
tools/convert_vgg16.py).

The reference starts VGG16 from torchvision's ImageNet weights (reference
src/model.py:204-207).  Given that file (``vgg16-397923af.pth``)::

    python -m umpr_tpu_torch.convert_vgg16 --pth vgg16-397923af.pth --out assets/vgg16

writes the directory that ``--vgg16_weights assets/vgg16`` loads, in the
JAX package's layout, which both packages read:

  features.{0,2,5,...}.weight (O, I, 3, 3) -> features[i].kernel (3, 3, I, O)  [OIHW -> HWIO]
  classifier.{0,3,6}.weight (O, I)        -> classifier[j].kernel (I, O)

and each bias as it is.  It runs on the CPU (no device work).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from umpr_tpu_torch.train.checkpoint import save_pytree


def vgg16_tree(state_dict):
    """torchvision VGG16 state dict -> {"features": [...], "classifier":
    [...]} of numpy arrays in the JAX layout."""
    conv = sorted({int(k.split(".")[1]) for k in state_dict
                   if k.startswith("features.") and k.endswith(".weight")})
    host = lambda k: state_dict[k].detach().cpu().numpy()
    features = [{"kernel": np.ascontiguousarray(
                    host(f"features.{i}.weight").transpose(2, 3, 1, 0)),  # OIHW -> HWIO
                 "bias": host(f"features.{i}.bias").copy()} for i in conv]
    classifier = [{"kernel": np.ascontiguousarray(host(f"classifier.{i}.weight").T),
                   "bias": host(f"classifier.{i}.bias").copy()} for i in (0, 3, 6)]
    return {"features": features, "classifier": classifier}


def convert(pth_path, out_dir):
    tree = vgg16_tree(torch.load(pth_path, map_location="cpu", weights_only=True))
    save_pytree(out_dir, tree)
    print(f"Converted {len(tree['features'])} convs + {len(tree['classifier'])} "
          f"linears -> {out_dir}")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--pth", required=True, help="torchvision vgg16 .pth state_dict")
    parser.add_argument("--out", required=True, help="output checkpoint dir")
    args = parser.parse_args(argv)
    convert(args.pth, args.out)


if __name__ == "__main__":
    main()
