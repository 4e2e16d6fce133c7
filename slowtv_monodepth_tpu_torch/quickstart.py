"""Checkpoint -> depth maps over an image directory (PyTorch port).

Counterpart of `api/quickstart/run.py`, with the same flags and steps: load
the depth net from the checkpoint's embedded cfg, resize each image
(aspect-preserving, snapped to multiples of 32), standardize, predict the
scale-0 disparity, resize it back to the source shape, and save a turbo
colormap png and/or the raw npy.

Reading image files (PIL) and writing pngs (matplotlib) sit at the edges,
imported where they are used; `predict` works on numpy arrays alone.

Usage:
    python -m slowtv_monodepth_tpu_torch.quickstart --ckpt-file best.ckpt \
        --img-dir imgs/ --out-dir out/
"""
from __future__ import annotations

from argparse import ArgumentParser
from pathlib import Path

import numpy as np
import torch

from .core.predictors import BenchmarkPredictor
from .ops import resize, standardize

__all__ = ['get_img_shape', 'load_img', 'predict', 'save_disp', 'main', 'cli']


def get_files(path: Path, ext: str) -> list:
    files = sorted(path.glob(f'*{ext}'))
    if not files:
        raise FileNotFoundError(f'No files found in "{path}" with extension "{ext}".')
    print(f'-> Found {len(files)} files to predict...')
    return files


def get_img_shape(shape, w: int, h: int) -> tuple:
    """Landscape -> fixed width; portrait -> fixed height; snap to mult-32."""
    img_h, img_w = shape
    new_h, new_w = (int(w * img_h / img_w), w) if img_w >= img_h else (h, int(h * img_w / img_h))
    return round(new_h / 32) * 32, round(new_w / 32) * 32


def load_img(img_file: Path) -> np.ndarray:
    """Image file -> (h, w, 3) float32 RGB in [0, 1]."""
    from PIL import Image
    return np.asarray(Image.open(img_file).convert('RGB'), np.float32) / 255.0


@torch.no_grad()
def predict(net, imgs: np.ndarray, width: int = 640, height: int = 384,
            device=None) -> np.ndarray:
    """(b, h, w, 3) or (h, w, 3) RGB in [0, 1] -> (b, h, w) or (h, w) disparity.

    All images of a batch share one shape. The net sees them resized to
    `get_img_shape` and ImageNet-standardized; its scale-0 disparity is
    resized back to (h, w).
    """
    single = imgs.ndim == 3
    imgs = imgs[None] if single else imgs
    ref_shape = imgs.shape[1:3]
    device = device or next(net.parameters()).device
    x = torch.from_numpy(np.ascontiguousarray(imgs, np.float32)).to(device)
    x = resize(x.permute(0, 3, 1, 2), get_img_shape(ref_shape, width, height))
    disp = net(standardize(x))['disp'][0]
    disp = resize(disp, ref_shape)[:, 0].cpu().numpy()
    return disp[0] if single else disp


def save_disp(disp: np.ndarray, img_file: Path, out_dir: Path, out_ext: list) -> None:
    name = Path(img_file).stem
    disp = np.asarray(disp).squeeze()
    for ext in out_ext:
        if ext == '.png':
            from PIL import Image

            from .tools.viz import rgb_from_disp
            rgb = (rgb_from_disp(disp) * 255).astype(np.uint8)
            Image.fromarray(rgb).save(out_dir / f'{name}{ext}')
        elif ext == '.npy':
            np.save(out_dir / f'{name}{ext}', disp)
        else:
            raise ValueError(f'Invalid extension "{ext}".')


def default_img_dir() -> Path:
    """`assets/demo`, generated on first use (assets/README.md)."""
    demo = Path(__file__).resolve().parents[1] / 'assets' / 'demo'
    if not (demo.is_dir() and any(demo.glob('*.png'))):
        import runpy
        print(f'-> Generating demo images in "{demo}"...')
        runpy.run_path(str(demo.parent / 'generate.py'), run_name='__main__')
    return demo


def main(args) -> None:
    if args.img_dir is None:
        args.img_dir = default_img_dir()
    net = BenchmarkPredictor(args.device).load_model(args.ckpt_file)
    if args.out_dir:
        args.out_dir.mkdir(parents=True, exist_ok=True)
        print(f'-> Saving predictions to "{args.out_dir}"...')
    for file in get_files(args.img_dir, args.img_ext):
        disp = predict(net, load_img(file), args.width, args.height)
        if args.out_dir:
            save_disp(disp, file, args.out_dir, args.out_ext)


def cli(argv=None) -> None:
    parser = ArgumentParser('Run KBR predictions on a directory of images (PyTorch).')
    parser.add_argument('--ckpt-file', type=Path, required=True)
    parser.add_argument('--img-dir', type=Path, default=None,
                        help='Defaults to assets/demo (generated on first '
                             'use; see assets/README.md).')
    parser.add_argument('--img-ext', default='.png')
    parser.add_argument('--out-dir', type=Path, default=None)
    parser.add_argument('--out-ext', nargs='+', default=['.png', '.npy'])
    parser.add_argument('--width', type=int, default=640)
    parser.add_argument('--height', type=int, default=384)
    parser.add_argument('--device', default='cuda')
    main(parser.parse_args(argv))


if __name__ == '__main__':
    cli()
