"""U-Net training engine (``torch.optim.Adam`` on the card).

The port of ``iterseg_tpu/train/train.py``: a batch-size-1 epoch loop with
per-channel loss logging, validation at the start of training and after
every epoch, per-epoch checkpoints, a timestamped final checkpoint, and
loss and validation CSVs. The same signature and results:
``(UNetModel, checkpoint_path)``, ``.npz`` checkpoints under the JAX
state-dict keys (never ``num_batches_tracked``), the same CSV and file
names. Runs on CUDA unless the caller passes ``device``.

Reference quirks kept:
- **Double optimiser step** (``double_step=True``): ``step()`` twice with
  the same, un-zeroed gradients, which advances Adam's moments twice.
- **Validation in train mode** (``validate_in_train_mode=True``): under
  ``no_grad`` with batch statistics, so validation updates the running
  stats. The validation loss's epoch is pinned at 0.
- Validation predictions are saved as multi-page float32 ``.tif`` files
  (``helpers.write_tiff``; the leading (batch, channel, z) axes are the
  page sequence).

The step (forward, loss, backward, one or two Adam steps) runs inside
``device.f32_numerics()``: TF32 off and deterministic cuDNN, as the
forward. Each batch is uploaded from pinned host memory without blocking,
and batch i+1 is read and uploaded while step i runs on the card.

``mesh`` / ``n_devices`` train over a device mesh
(``parallel.mesh.make_sharded_train_step``), after JAX: each step takes
``data``-many chunks (the tail batch repeat-pads its last chunk), each
chunk's x axis split over ``space``; BatchNorm takes the statistics of the
whole batch, the loss is its global mean, and a loss-CSV row names the
step's unique chunk ids joined by ``;``.

Not ported: the JAX trainer's bit-packed label upload, which exists for a
TPU host's thin link and gives bit-equal losses by construction.
"""
from __future__ import annotations

import os
from datetime import datetime

import numpy as np
import torch

from ..device import f32_numerics, resolve_device
from ..helpers import LINE, write_csv, write_log, write_tiff
from ..models.convert import (load_checkpoint, params_from_numpy,
                              params_to_numpy, save_checkpoint)
from ..models.swin_unetr import is_swin_unetr
from ..models.unet import UNet, UNetSpec
from ..utils import span
from .losses import channel_losses, make_loss_function
from .train_io import load_tensor_from_zarr

__all__ = ["train_unet"]


def _upload(a, device):
    """A host array as a f32 tensor on ``device``: on a card, copied from
    pinned memory without blocking the host."""
    t = torch.from_numpy(np.array(a, dtype=np.float32))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def train_unet(
    # training data
    x,
    vx,
    y,
    vy,
    ids=None,
    vids=None,
    # output information
    out_dir=None,
    name="my-unet",
    channels=None,
    # training variables
    validate=True,
    log=True,
    epochs=3,
    lr=0.01,
    loss_function="BCELoss",
    chan_weights=None,
    weights=None,
    update_every=20,
    losses=None,
    chan_losses=None,
    # network architecture
    fork_channels=None,
    chan_final_activations=None,
    # quirk switches (see module docstring)
    double_step=True,
    validate_in_train_mode=True,
    seed=0,
    # training over a device mesh (data x space)
    mesh=None,
    n_devices=None,
    *,
    device=None,
    profile=None,
    **kwargs,
):
    """Train the anisotropic U-Net; returns ``(model, unet_path)``.

    ``x/vx``: lists of (z, y, x) image chunks (arrays or zarr-backed);
    ``y/vy``: matching (C, z, y, x) target chunks. ``weights``: a
    checkpoint path or a dict of arrays under the state-dict keys.
    ``device``: where training runs (CUDA unless given). ``profile``: a
    dict that receives ``step_s`` (each train step's wall seconds, from
    its dispatch to the read of its loss, the next batch's load and upload
    included), ``load_s`` (each batch's read and upload dispatch) and
    ``validation_s`` (each validation pass), from the spans ``step``
    (the step's dispatch), ``read`` (its loss reads), ``load`` and
    ``validation``.

    ``mesh`` (a ``parallel.mesh.Mesh``) trains over its data x space
    blocks (see the module docstring); the master parameters, the
    optimizer and validation live on its first device, and ``device`` is
    not used. ``n_devices`` builds the mesh with ``make_mesh`` over the
    first ``n_devices`` CUDA cards, as JAX's does over its devices (2 and 4
    cards make a ``space`` mesh). ``mesh=None`` keeps the batch-1 loop.
    """
    from ..engine.predict import UNetModel
    from ..parallel import mesh as mesh_mod

    if mesh is None and n_devices is not None:
        mesh = mesh_mod.make_mesh(int(n_devices))
    if mesh is not None:
        dp, sp, mesh_devices = mesh_mod._grid(mesh)
    dev = resolve_device(device if mesh is None else mesh_devices[0])
    save_output = out_dir is not None
    print("Output will be saved: ", save_output)
    print("Save directory: ", out_dir)
    if ids is None:
        ids = [name + f"_{i}" for i in range(len(x))]
    if vids is None:
        vids = [name + f"_val_{i}" for i in range(len(vx))]
    channels = _index_channels_if_none(channels, y)
    out_channels = (len(channels) if fork_channels is None
                    else tuple(fork_channels))
    spec = UNetSpec(1, out_channels,
                    chan_final_activations=chan_final_activations)
    weights_are = "naive"
    if weights is None:
        net = UNet(spec).init_weights(seed)
    else:
        if isinstance(weights, (str, os.PathLike)):
            params = load_checkpoint(weights)
        else:
            params = {k: np.asarray(v) for k, v in dict(weights).items()}
        if is_swin_unetr(params):
            raise ValueError("train_unet trains the U-Net; a Swin UNETR "
                             "checkpoint cannot be trained (its window "
                             "attention has no backward)")
        net = params_from_numpy(params, spec)
        weights_are = "pretrained"
    net = net.to(dev).train()
    optimizer = torch.optim.Adam(net.parameters(), lr=lr, betas=(0.9, 0.999),
                                 eps=1e-8)
    loss_fn = make_loss_function(loss_function, chan_weights, losses,
                                 chan_losses)
    chan_log_fn = (
        loss_fn
        if loss_function in ("BCELoss", "DiceLoss", "DICELoss", "MSELoss")
        else make_loss_function("BCELoss")
    )
    loss_dict = _get_loss_dict(channels)
    validation_dict = {"epoch": [], "validation_loss": [], "data_id": [],
                       "batch_id": []}
    _print_train_info(loss_function, chan_weights, epochs, lr, weights_are,
                      str(dev), out_dir, log and save_output, chan_losses,
                      losses, channels, fork_channels)
    timings = {"step_s": [], "load_s": [], "validation_s": []}
    # the spans' totals; ``profile`` gets the per-step lists of ``timings``
    timed = None if profile is None else {}

    def load(img, tgt):
        with span("load", timed) as s:
            xb = _upload(load_tensor_from_zarr(0, [img])[None, None], dev)
            yb = _upload(load_tensor_from_zarr(0, [tgt])[None], dev)
        timings["load_s"].append(s.seconds)
        return xb, yb

    if mesh is None:
        steps = [[i] for i in range(len(x))]

        def load_step(idxs):
            return load(x[idxs[0]], y[idxs[0]])

        def step_id(idxs):
            return ids[idxs[0]]
    else:
        # dp chunks a step, the tail batch repeat-padded (JAX parity)
        steps = []
        for b0 in range(0, len(x), dp):
            idxs = list(range(b0, min(b0 + dp, len(x))))
            steps.append(idxs + [idxs[-1]] * (dp - len(idxs)))
        sharded_step = mesh_mod.make_sharded_train_step(
            mesh, net, loss_fn, optimizer, double_step=double_step,
            chan_log_fn=chan_log_fn, n_channels=len(channels))

        def load_step(idxs):
            """The step's chunks: x as the mesh's (1, 1, z, y, x / space)
            blocks, each on its device, y whole on the first."""
            with span("load", timed) as s:
                xb = np.stack([load_tensor_from_zarr(0, [x[i]])
                               for i in idxs])
                xb = [_upload(blk, d) for blk, d in zip(mesh_mod._blocks(
                    torch.from_numpy(xb[:, None]), dp, sp), mesh_devices)]
                yb = _upload(np.stack([load_tensor_from_zarr(0, [y[i]])
                                       for i in idxs]), dev)
            timings["load_s"].append(s.seconds)
            return xb, yb

        def step_id(idxs):
            return ";".join(ids[i] for i in dict.fromkeys(idxs))

    def train_step(xb, yb, e):
        optimizer.zero_grad(set_to_none=True)
        out = net(xb)
        loss = loss_fn(out, yb, e)
        loss.backward()
        optimizer.step()
        if double_step:
            # the same un-zeroed gradients again (reference parity)
            optimizer.step()
        with torch.no_grad():
            chan = torch.stack(channel_losses(out, yb, chan_log_fn,
                                              len(channels), e))
        return loss.detach(), chan

    def run_validation(e, batch_no):
        v_y_hats = []
        total = 0.0
        with span("validation", timed) as s:
            if not validate_in_train_mode:
                net.eval()
            with torch.no_grad():
                for i in range(len(vx)):
                    xb, yb = load(vx[i], vy[i])
                    out = net(xb)
                    # the loss epoch is PINNED at 0 for validation: the
                    # reference sets its validation loss's epoch only at
                    # e == 0
                    vl = float(loss_fn(out, yb, 0))
                    v_y_hats.append(out.cpu().numpy())
                    total += vl
                    validation_dict["epoch"].append(e)
                    validation_dict["validation_loss"].append(vl)
                    validation_dict["data_id"].append(vids[i])
                    validation_dict["batch_id"].append(batch_no)
            net.train()
        timings["validation_s"].append(s.seconds)
        if len(vx):
            s = f"Epoch {e} - validation loss: {total / len(vx)}"
            print(s)
            if log and save_output:
                write_log(s, out_dir)
        return v_y_hats

    step_fn = train_step if mesh is None else sharded_step
    v_y_hats = None
    with f32_numerics():
        for e in range(epochs):
            if validate and e == 0:
                v_y_hats = run_validation(0, 0)
            running_loss = 0.0
            batch = load_step(steps[0]) if steps else None
            for si, idxs in enumerate(steps):
                with span("step", timed) as dispatched:
                    xb, yb = batch
                    loss, chan = step_fn(xb, yb, e)
                if si + 1 < len(steps):
                    # double-buffer: read and upload the next batch while
                    # the dispatched step runs on the card
                    batch = load_step(steps[si + 1])
                    loaded = timings["load_s"][-1]
                else:
                    loaded = 0.0
                with span("read", timed) as read:
                    loss = float(loss)
                    chan = chan.cpu().numpy()
                timings["step_s"].append(dispatched.seconds + loaded
                                         + read.seconds)
                loss_dict["epoch"].append(e)
                loss_dict["batch_num"].append(si)
                loss_dict["loss"].append(loss)
                loss_dict["data_id"].append(step_id(idxs))
                for ci, c in enumerate(channels):
                    loss_dict[c].append(float(chan[ci]))
                running_loss += loss
                if si % update_every == (update_every - 1):
                    s = (f"Epoch {e} - running loss: "
                         f"{running_loss / update_every}")
                    print(s)
                    if log and save_output:
                        write_log(s, out_dir)
                    running_loss = 0.0
            if validate:
                v_y_hats = run_validation(e, (e + 1) * len(steps))
            if save_output:
                print("Saving Training Checkpoint...")
                _save_checkpoint_file(params_to_numpy(net), out_dir,
                                      f"{name}_epoch-{e}")
    if profile is not None:
        profile.update(timings)
    params = params_to_numpy(net)
    unet_path = None
    if save_output:
        print("Saving Final Results...")
        unet_path = _save_final_results(params, out_dir, name, validate,
                                        loss_dict, v_y_hats, vids,
                                        validation_dict)
    return UNetModel(params, spec), unet_path


# ---------------------------------------------------------------------------
# bookkeeping (parity: train.py:228-432)
# ---------------------------------------------------------------------------


def _index_channels_if_none(channels, y):
    if channels is None:
        first = y[0]
        # shape is metadata for arrays/zarr — don't read the whole chunk
        c = (first.shape[0] if hasattr(first, "shape")
             else np.asarray(first).shape[0])
        return tuple("channel_" + str(i) for i in range(c))
    return tuple(channels)


def _get_loss_dict(channels):
    loss_dict = {"epoch": [], "batch_num": [], "loss": [], "data_id": []}
    for c in channels:
        loss_dict[c] = []
    return loss_dict


def _print_train_info(loss_function, chan_weights, epochs, lr, weights_are,
                      device_name, out_dir, log, chan_losses, losses,
                      channels, fork_channels):
    s = LINE + "\n" + f"Loss function: {loss_function} \n"
    if chan_weights is not None:
        s += f"    Loss function channel weights: {chan_weights} \n"
    if losses is not None:
        for i, l in enumerate(losses):
            s += f"    Loss for channels {chan_losses[i]}: {l}\n"
    s += "Optimiser: Adam \n" + f"Learning rate: {lr} \n" + LINE + "\n"
    s += f"Training {weights_are} U-net for {epochs} epochs with batch size 1 \n"
    s += f"Device: {device_name} \n"
    if channels is not None:
        s += f"Channels: {channels}\n"
    if fork_channels is not None:
        s += (
            f"Channels per fork (according to channel order): "
            f"{fork_channels}\n"
        )
    s += LINE
    print(s)
    if log:
        write_log(LINE, out_dir)
        write_log(s, out_dir)


def _save_checkpoint_file(params, out_dir, name, r=False):
    d = datetime.now().strftime("%y%d%m_%H%M%S")
    fname = d + "_unet_" + name + ".npz"
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, fname)
    save_checkpoint(params, path)
    if r:
        return path


def _save_final_results(params, out_dir, name, validate, loss_dict,
                        v_y_hats, v_ids, validation_dict):
    unet_path = _save_checkpoint_file(params, out_dir, name, r=True)
    write_csv(os.path.join(out_dir, "loss_" + name + ".csv"), loss_dict)
    if validate:
        _save_output(v_y_hats, v_ids, out_dir, name="_validation")
        write_csv(os.path.join(out_dir, "validation-loss_" + name + ".csv"),
                  validation_dict)
    return unet_path


def _save_output(y_hats, ids, out_dir, name=""):
    """Save validation predictions as multi-page float32 TIFFs named
    ``<id><name>_output.tif`` (the leading (batch, channel, z) axes are
    flattened into the page sequence)."""
    if y_hats is None:
        return
    assert len(y_hats) == len(ids)
    os.makedirs(out_dir, exist_ok=True)
    for i in range(len(y_hats)):
        write_tiff(os.path.join(out_dir, ids[i] + name + "_output.tif"),
                   y_hats[i])
