"""Convert the reference's torch checkpoints to flax ``.msgpack`` variable
files, with torch and numpy only (port of ``dvd_tpu/cli/convert_ckpt.py``;
the files are the ones ``dvd_tpu``'s converter writes).

    python -m dvd_tpu_torch.cli.convert_ckpt --kind dit  --src model1852000.pt --dst checkpoints/model1852000.msgpack
    python -m dvd_tpu_torch.cli.convert_ckpt --kind seg  --src seg.pth        --dst checkpoints/seg.msgpack
    python -m dvd_tpu_torch.cli.convert_ckpt --kind seg_model --src seg_model.pth --dst checkpoints/seg_model.msgpack
    python -m dvd_tpu_torch.cli.convert_ckpt --kind line --src line_model2.pth --dst checkpoints/line_model2.msgpack
    python -m dvd_tpu_torch.cli.convert_ckpt --kind vgg  --src vgg16.pth      --dst checkpoints/vgg16.msgpack

Kinds encode each file's quirks (reference ``geotr_core.py:1075-1111``,
``val_TDiff.py:66-79``):

- ``seg``        'module.'-prefixed GeoTr_Seg state dict (strip 7)
- ``seg_model``  nested under the 'model' sub-dict
- ``line``       nested under the 'model' sub-dict
- ``dit``        plain DiT state dict
- ``vgg``        torchvision vgg16 state dict

``--validate`` loads the converted tree into the port's module through
the weight bridge (``training/convert.py:load_variables``), which raises
on a missing, unexpected or mis-shaped leaf: the DiT-S/2, the whole
``GeoTrSegInf`` (U2NetP mask and GeoTr), ``Seg``, the line UNet or the
``VGG16Pyramid``.
"""

from __future__ import annotations

import argparse
from typing import Optional

from dvd_tpu_torch.training import convert as C
from dvd_tpu_torch.training.checkpoint import save_variables

# kind -> (load_torch_state_dict keywords, rule set)
KINDS = {
    "dit": ({}, C.DIT_RULES),
    "seg": ({"strip_prefix": 7}, C.GEOTR_SEG_RULES),
    "seg_model": ({"sub_key": "model"}, C.U2NETP_RULES),
    "line": ({"sub_key": "model"}, C.LINE_UNET_RULES),
    "vgg": ({}, C.VGG16_RULES),
}


def port_module(kind: str):
    """The port's module a converted ``kind`` loads into, at the shipped
    sizes (GeoTr's query bank: 288^2 / 8^2 tokens)."""
    if kind == "dit":
        from dvd_tpu_torch.models.dit import make_dit

        return make_dit("DiT-S/2", input_size=64, tv=True)
    if kind == "seg":
        from dvd_tpu_torch.models.geotr import GeoTrSegInf

        return GeoTrSegInf(full=True)
    if kind == "seg_model":
        from dvd_tpu_torch.models.u2net import Seg

        return Seg()
    if kind == "line":
        from dvd_tpu_torch.models.textline_unet import TextLineUNet

        return TextLineUNet()
    from dvd_tpu_torch.models.vgg import VGG16Pyramid

    return VGG16Pyramid()


def convert(kind: str, src: str, dst: str, validate: bool = False) -> dict:
    if kind not in KINDS:
        raise SystemExit(f"unknown kind {kind}")
    load_kw, rules = KINDS[kind]
    variables = C.convert_state_dict(C.load_torch_state_dict(src, **load_kw),
                                     rules)
    if validate:
        module = port_module(kind)
        C.load_variables(module, variables)
        print(f"validated against the port's {type(module).__name__}")
    save_variables(dst, variables)
    n = sum(v.size for v in C.flatten_tree(variables).values())
    print(f"wrote {dst}: {n / 1e6:.2f}M scalars")
    return variables


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kind", required=True, choices=sorted(KINDS))
    ap.add_argument("--src", required=True)
    ap.add_argument("--dst", required=True)
    ap.add_argument("--validate", action="store_true")
    a = ap.parse_args(argv)
    convert(a.kind, a.src, a.dst, a.validate)


if __name__ == "__main__":
    main()
