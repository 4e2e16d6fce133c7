"""Checkpoints in the reference's Lightning layout.

A file holds `{'state_dict': {'nets.depth.<key>': tensor, ...},
'hyper_parameters': {'cfg': cfg}}`: what the reference saves, what
`api/data/import_reference_ckpt.py` (JAX package) reads, and what
`load_checkpoint` here reads, so released reference checkpoints load as
they are. The JAX package's own orbax checkpoints come across through
`models.from_jax` (see that module).
"""
from __future__ import annotations

from pathlib import Path
from typing import Mapping

import torch

__all__ = ['save_checkpoint', 'load_checkpoint', 'net_state_dict']


def save_checkpoint(path, nets: Mapping[str, Mapping[str, torch.Tensor]],
                    cfg: dict) -> None:
    """:param nets: net name ('depth', ...) -> that net's `state_dict()`."""
    sd = {f'nets.{name}.{k}': v.detach().cpu()
          for name, net_sd in nets.items() for k, v in net_sd.items()}
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({'state_dict': sd, 'hyper_parameters': {'cfg': cfg}}, path)


def load_checkpoint(path) -> tuple[dict[str, torch.Tensor], dict]:
    """-> (full state dict with `nets.*` keys, cfg)."""
    ckpt = torch.load(Path(path), map_location='cpu', weights_only=False)
    return ckpt['state_dict'], dict(ckpt.get('hyper_parameters', {}).get('cfg', {}))


def net_state_dict(sd: Mapping[str, torch.Tensor], name: str) -> dict:
    """The `nets.<name>.` sub-dict with the prefix stripped."""
    pre = f'nets.{name}.'
    out = {k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)}
    if not out:
        raise ValueError(f'No "{pre}*" weights in the checkpoint.')
    return out
