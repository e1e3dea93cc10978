from .package import InferencePackage, export_checkpoint

__all__ = ["InferencePackage", "export_checkpoint"]
