"""AECF in PyTorch + CUDA: the port of ``aecf_tpu`` to an NVIDIA H100.

The JAX package ``aecf_tpu`` is the reference; this package imports
``torch`` and never ``jax``.  Public API (the reference's
``aecf/__init__.py``): ``CurriculumMasking``, ``MultimodalAttentionPool``,
``multimodal_attention_pool``, ``create_fusion_pool``.  Ported so far — the module API, the model
families, the serving path, the training loop, the data pipeline and the
measurement layer:

    aecf_tpu_torch.nn            — the four public symbols (nn.Modules)
    aecf_tpu_torch.core          — pure functions (the CPU oracle)
    aecf_tpu_torch.kernels       — hand-written CUDA kernels for Hopper,
                                   each with its plain PyTorch version
    aecf_tpu_torch.ops           — fusion_pool, dispatching kernel/oracle
    aecf_tpu_torch.models        — VisionLanguageModel,
                                   MedicalDiagnosisModel, XrayAECFModel,
                                   XrayBaselineModel, MultiScaleFusion
    aecf_tpu_torch.serve         — FusionPredictor, MicroBatcher,
                                   export_predictor and
                                   load_exported_predictor (frozen
                                   torch.export artifacts)
    aecf_tpu_torch.serving_http  — PredictionServer, predict_remote
    aecf_tpu_torch.train         — fit (checkpoint/resume),
                                   make_pool_train_step and the K-step
                                   chunk (a CUDA graph on the card),
                                   checkpoints, metrics, evaluation and
                                   the baseline-vs-AECF experiment
    aecf_tpu_torch.data          — the prefetching BatchLoader over the
                                   native C++ batcher (``native/``),
                                   quantize_rows, pathology report
                                   mining, synthetic CLIP-like features
    aecf_tpu_torch.measure       — build_chunk and the alternating-window
                                   timing discipline
    aecf_tpu_torch.utils         — trace, named_scope, StepTimer,
                                   debug_nans, finiteness reports
    aecf_tpu_torch.parallel      — meshes over torch.distributed ranks,
                                   data- and tensor-parallel steps
                                   (``mesh=`` on the pool steps, fit and
                                   FusionPredictor)
    aecf_tpu_torch.convert       — JAX parameters, flattened to numpy,
                                   into the port's modules
    aecf_tpu_torch.tune          — the launch-plan tuner (with
                                   ``kernels/tiles.py``, the per-card
                                   plan table)

``precision`` follows the JAX package: ``'highest'`` is IEEE f32;
``'default'`` runs the kernels' products on TF32 tensor cores on the card
(IEEE f32 on the CPU, as JAX's CPU backend) and stores the streamed
split's ``mix`` and ``d_mix`` in bf16.  Not ported (ROADMAP.md): the
JAX package's ``contrib/``.

Importing the package touches no CUDA and builds nothing; it registers
the eval-forward kernels as the custom ops ``aecf_tpu_torch::
shared_query_fwd``, ``::stream_mix`` and ``::fused_pool_fwd``.  A kernel
is compiled at its first launch, the native batcher at its first use.
"""

from .nn import (
    CurriculumMasking,
    MultimodalAttentionPool,
    create_fusion_pool,
    multimodal_attention_pool,
)

__version__ = "0.1.0"
__all__ = [
    "CurriculumMasking",
    "MultimodalAttentionPool",
    "multimodal_attention_pool",
    "create_fusion_pool",
]
