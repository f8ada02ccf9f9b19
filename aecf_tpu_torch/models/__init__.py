"""Model families, in PyTorch: the vision-language, medical, X-ray and
multi-scale integration patterns of the JAX package."""

from .layers import (
    LinearParams,
    dropout,
    fork_generator,
    init_linear,
    linear,
    mlp_encoder,
)
from .medical import MedicalDiagnosisModel
from .multiscale import MultiScaleFusion
from .vision_language import VisionLanguageModel
from .xray import PRESENCE_EPS, XrayAECFModel, XrayBaselineModel

__all__ = [
    "LinearParams",
    "dropout",
    "fork_generator",
    "init_linear",
    "linear",
    "mlp_encoder",
    "MedicalDiagnosisModel",
    "MultiScaleFusion",
    "VisionLanguageModel",
    "PRESENCE_EPS",
    "XrayAECFModel",
    "XrayBaselineModel",
]
