"""slowtv_monodepth_tpu_torch: the PyTorch + CUDA port of slowtv_monodepth_tpu.

The JAX package `slowtv_monodepth_tpu` stays the reference; this package
mirrors its layout (`ops/`, `models/encoders/`, `models/decoders/`, `core/`)
and is held against it by the `tests/test_torch_*.py` differentials. It
imports torch and numpy only, never JAX.

Ported so far: the serving path of the KBR depth model (ConvNeXt encoder +
Monodepth decoder -> `core.BenchmarkPredictor` -> `quickstart`), the KBR
training step (`core.trainer.MonoDepthTrainer`, `parsers.make_optimizer`:
depth and pose nets, view synthesis, the photometric and smoothness losses,
AdamW with gradient accumulation) and the training run around it
(`train` -> `core.loop.MonoDepthLoop`: loader, on-device input derivation,
aspect-ratio augmentation, validation, last/best checkpoints, resume) and
evaluation (`export_gt` -> `export_preds` -> `eval_depth` ->
`generate_tables`, with `eval.MonoDepthEvaluator` on numpy and scipy) on
every dataset of the JAX package's registry, release validation
(`validate_release`) and MapFreeReloc's challenge predictions
(`mapfree_preds`). Each
TPU kernel on those paths has a hand-written Hopper kernel in `csrc/`, built
with nvcc at first use (`_build.py`): the depthwise conv and its tap gradient
(`ops.dwconv`), the fused decoder stage forward and backward
(`ops.decoder_stage`), the warp on float32 and on packed bfloat16 sources
(`ops.sample`) and the photometric error forward and backward (`ops.photo`).
On a CUDA tensor they launch the kernel; on a CPU tensor they run their plain
PyTorch version.
"""
import logging

__version__ = '0.1.0'

LOGGER = logging.getLogger('slowtv_torch')
if not LOGGER.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter('[%(asctime)s %(name)s %(levelname)s] %(message)s'))
    LOGGER.addHandler(_h)
    LOGGER.setLevel(logging.INFO)
