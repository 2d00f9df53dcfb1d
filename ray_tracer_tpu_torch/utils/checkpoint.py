"""Checkpoint / resume for progressive renders and inverse rendering.

Port of ``ray_tracer_tpu.utils.checkpoint``, in its file layout: one
``.npz`` holding arrays and a JSON string ``meta`` (``_FORMAT_VERSION``
1), read with ``allow_pickle=False``.

Renderer files: ``image`` (the accumulated (H, W, 3) float32 image, or
an empty array before the first frame) and ``meta`` = {version, frames,
params, camera}. The scene is not stored: it is rebuilt from its builder
or loader. ``load_renderer`` also reads a file the JAX package wrote and
continues its accumulation; that package's ``backend`` values map to the
port's: "jnp" -> "torch", "pallas" -> "auto".

Training files: ``trainable__<k>`` per trainable leaf, and the optimizer's
state as plain arrays, no pickle:

  * written here (``meta["optimizer"] == "torch"``): ``opt__<i>__<name>``
    for each tensor ``name`` in ``torch.optim`` state of parameter ``i``;
    ``meta["param_keys"]`` names the trainable leaf of parameter ``i``
    and ``meta["opt_scalars"]`` holds the state's non-tensor values;
  * written by the JAX package (no ``meta["optimizer"]``): ``opt__<j>``,
    the leaves of its flattened optax state. For Adam
    (``optax.adam``: ``ScaleByAdamState(count, mu, nu)``, then empty
    states, or a schedule's count) these are the count, then ``mu`` and
    then ``nu`` of each leaf in sorted key order; they load into
    ``torch.optim.Adam`` as ``step``, ``exp_avg`` and ``exp_avg_sq``.

Either way the hyperparameters (learning rate, betas) are the template
optimizer's, as an optax state carries none.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..camera import Camera
from ..renderer import Renderer
from .config import RenderParams

_FORMAT_VERSION = 1
# the JAX package's backends, as the port names them
_REFERENCE_BACKENDS = {"jnp": "torch", "pallas": "auto"}


def _read(path: str):
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        if meta["version"] != _FORMAT_VERSION:
            raise ValueError(
                f"unsupported checkpoint version {meta['version']}")
        return meta, {k: z[k] for k in z.files if k != "meta"}


def save_renderer(path: str, renderer: Renderer) -> None:
    """Persist the accumulation state, camera and params (not the scene:
    scenes are rebuilt from their builders and loaders)."""
    img = (renderer._image.detach().cpu().numpy().astype(np.float32)
           if renderer._image is not None else np.zeros((0,)))
    meta = {
        "version": _FORMAT_VERSION,
        "frames": renderer.frames,
        "params": dataclasses.asdict(renderer.params),
        "camera": dataclasses.asdict(renderer.camera),
    }
    np.savez_compressed(path, image=img, meta=json.dumps(meta))


def load_renderer(path: str, scene) -> Renderer:
    """Rebuild a Renderer from a checkpoint (this package's or the JAX
    package's) and a rebuilt scene; rendering continues from the saved
    frame counter with the same accumulation weights, on the scene's
    device."""
    meta, arrays = _read(path)
    kw = dict(meta["params"])
    kw["backend"] = _REFERENCE_BACKENDS.get(kw["backend"], kw["backend"])
    params = RenderParams(**kw)
    cam_kw = meta["camera"]
    for k in ("origin", "look_at", "vup"):
        cam_kw[k] = tuple(cam_kw[k])
    r = Renderer(scene, Camera(**cam_kw), params)
    r.frames = meta["frames"]
    if arrays["image"].size:
        r._image = torch.from_numpy(arrays["image"]).to(scene.device)
    return r


def save_training(path: str, trainable: Dict[str, Any], opt_state,
                  step: int, extra: Optional[dict] = None) -> None:
    """Persist inverse-rendering state: the trainable leaves, the
    ``torch.optim`` optimizer's state (``opt_state``, made by
    ``make_train_step``'s ``init_fn`` over ``trainable``) and the step."""
    params = [p for g in opt_state.param_groups for p in g["params"]]
    by_id = {id(v): k for k, v in trainable.items()}
    state = opt_state.state_dict()
    arrays = {f"trainable__{k}": v.detach().cpu().numpy()
              for k, v in trainable.items()}
    scalars = {}
    for i, st in state["state"].items():
        for name, v in st.items():
            if isinstance(v, torch.Tensor):
                arrays[f"opt__{i}__{name}"] = v.detach().cpu().numpy()
            else:
                scalars.setdefault(str(i), {})[name] = v
    meta = {
        "version": _FORMAT_VERSION, "step": step,
        "trainable_keys": sorted(trainable.keys()),
        "optimizer": "torch",
        "param_keys": [by_id[id(p)] for p in params],
        "opt_state_keys": {str(i): sorted(st) for i, st
                           in state["state"].items()},
        "opt_scalars": scalars,
        "extra": extra or {},
    }
    np.savez_compressed(path, meta=json.dumps(meta), **arrays)


def _reference_adam_state(meta, arrays, keys):
    """optax Adam's flattened (count, mu..., nu...) as torch.optim.Adam
    state per leaf key (module docstring)."""
    n = len(meta["trainable_keys"])
    if meta["n_opt_leaves"] < 1 + 2 * n:
        raise ValueError("not an optax Adam state: "
                         f"{meta['n_opt_leaves']} leaves for {n} trainables")
    order = meta["trainable_keys"]            # sorted, as optax flattens
    count = float(arrays["opt__0"])
    out = {}
    for j, k in enumerate(order):
        if k in keys:
            out[k] = {"step": torch.tensor(count, dtype=torch.float32),
                      "exp_avg": torch.from_numpy(arrays[f"opt__{1 + j}"]),
                      "exp_avg_sq": torch.from_numpy(
                          arrays[f"opt__{1 + n + j}"])}
    return out


def load_training(path: str, template) -> Tuple[dict, Any, int, dict]:
    """Restore (trainable, opt_state, step, extra) into ``template``, the
    (trainable, opt_state) pair that ``make_train_step``'s ``init_fn``
    returns for the same fields: the port's optimizer owns its parameter
    tensors, so the file's values are copied into the template's leaves
    and its state is loaded into the template's optimizer. Reads files of
    this package and the JAX package's Adam files (module docstring)."""
    trainable, opt = template
    meta, arrays = _read(path)
    if set(meta["trainable_keys"]) != set(trainable):
        raise ValueError(f"checkpoint trains {meta['trainable_keys']}, "
                         f"the template {sorted(trainable)}")
    with torch.no_grad():
        for k, v in trainable.items():
            v.copy_(torch.from_numpy(arrays[f"trainable__{k}"]))
    slot = {id(p): i for i, p in enumerate(
        p for g in opt.param_groups for p in g["params"])}
    index = {k: slot[id(v)] for k, v in trainable.items()}
    if meta.get("optimizer") == "torch":
        per_key = {}
        for i, k in enumerate(meta["param_keys"]):
            st = {name: torch.from_numpy(arrays[f"opt__{i}__{name}"])
                  for name in meta["opt_state_keys"].get(str(i), ())}
            st.update(meta["opt_scalars"].get(str(i), {}))
            if st:
                per_key[k] = st
    else:
        if not isinstance(opt, torch.optim.Adam):
            raise ValueError("a JAX-written training checkpoint loads into "
                             "torch.optim.Adam only")
        per_key = _reference_adam_state(meta, arrays, set(trainable))
    sd = opt.state_dict()
    sd["state"] = {index[k]: st for k, st in per_key.items()}
    opt.load_state_dict(sd)
    return trainable, opt, meta["step"], meta["extra"]
