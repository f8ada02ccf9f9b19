"""Model families, in PyTorch (the vision-language model so far)."""

from .vision_language import VisionLanguageModel

__all__ = ["VisionLanguageModel"]
