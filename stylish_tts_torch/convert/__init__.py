from .from_jax import text_aligner_from_jax, text_aligner_to_jax_flat

__all__ = ["text_aligner_from_jax", "text_aligner_to_jax_flat"]
