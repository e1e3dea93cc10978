import json
import os.path as osp

from .kokoro import KokoroPackage
from .package import InferencePackage, export_checkpoint
from .programs import BucketPackage


def open_package(package_dir: str, device: str = "cuda") -> BucketPackage:
    """The package in ``package_dir`` as its family's class: a
    ``KokoroPackage`` where ``metadata.json`` names the family ``kokoro``
    (``export_kokoro`` writes it), an ``F5Package`` where it names ``f5``
    (``export_f5``; imported only then, so that the other families' set-up
    does not pay for it), else an ``InferencePackage``."""
    with open(osp.join(package_dir, "metadata.json"), encoding="utf-8") as f:
        family = json.load(f).get("family")
    if family == "f5":
        from .f5 import F5Package as cls
    else:
        cls = KokoroPackage if family == "kokoro" else InferencePackage
    return cls(package_dir, device=device)


__all__ = ["InferencePackage", "KokoroPackage", "export_checkpoint", "open_package"]
