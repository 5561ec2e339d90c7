"""AOT model export (port of umpr_tpu/export.py): the predict function as a
``torch.export`` artifact, and inference from the artifact alone.

The artifact is the forward graph of the kernel-free model
(``ModelDims.use_kernels`` False, the JAX package's ``from_config(config,
use_pallas=False)``): ``bigru_scan`` for the bi-GRU, the composite pool
and, below the long-history threshold (batch_size * P^2 * 4 bytes of
attention, ``ops.attention.TILED_BYTES_THRESHOLD``), the composite
attention.  Such an artifact is kernel-free: like the JAX package's
StableHLO artifact, it is served by any process with torch installed, and
no umpr_tpu_torch code is needed to load and run it.

Above the threshold the JAX package bakes its tiled Pallas kernel into the
artifact, and the port bakes in K7/K8 as the custom ops
``umpr_tpu_torch::affinity_tiles`` / ``affinity_finish``
(``ops.attention.affinity_attention_ops``; the composite would hold a 17
GB (B, P, P) tensor at (64, 8192)).  A long-history artifact therefore
needs umpr_tpu_torch importable where it is loaded, as the JAX artifact
needs Pallas: ``load_predict`` registers the ops.  On the card they launch
the kernels; on the CPU they run the plain versions.  The metadata's
``"custom_ops"`` names the custom ops in the graph (``[]`` below the
threshold).

    # export (shapes are static; one artifact per batch spec)
    python -m umpr_tpu_torch.export --model_path model/<run> --output umpr.pt2 \\
        --data_dir data/music --word2vec_file glove.txt [--device cpu]

    # serve from the artifact
    from umpr_tpu_torch.export import load_predict
    predict, params = load_predict("umpr.pt2")        # params from the sidecar
    preds = predict(params, batch)

Weights are not baked into the graph: the program takes (params, batch),
and a sidecar ``.params.npz`` carries the checkpoint's parameters in the
JAX package's layout and keys, so either package's sidecar loads into the
other's artifact, and a re-trained model reuses the artifact when shapes
match.  The program is traced on ``--device`` (default cuda);
``load_predict(path, device)`` moves it to another device with
``torch.export.passes.move_to_device_pass``, so one artifact serves the
CPU and the card: the port's form of the JAX package's ``--platforms``,
and the port has no such flag.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
from torch import nn

from umpr_tpu_torch.convert import params_from_jax, params_to_jax
from umpr_tpu_torch.models.umpr import UMPR, ModelDims
from umpr_tpu_torch.ops import attention
from umpr_tpu_torch.ops import attention_cuda  # noqa: F401  (registers K7/K8's custom ops)

CUSTOM_OP_NAMESPACE = "umpr_tpu_torch"


def batch_spec(config, dims: ModelDims):
    """{key: (shape, dtype)} of the loader's batch at the config's static
    shapes (umpr_tpu_torch/data/loader.py), photos uint8 for full UMPR."""
    B = config.batch_size
    S, L = config.max_sent_count, config.max_sent_length
    S_ui = config.max_ui_sent_count
    i32 = torch.int32
    spec = {
        "u_tokens": ((B, S, L), i32), "u_lengths": ((B, S), i32),
        "u_counts": ((B,), i32),
        "i_tokens": ((B, S, L), i32), "i_lengths": ((B, S), i32),
        "i_counts": ((B,), i32),
        "ui_tokens": ((B, S_ui, L), i32), "ui_lengths": ((B, S_ui), i32),
        "ui_counts": ((B,), i32),
        "ratings": ((B,), torch.float32), "sample_mask": ((B,), torch.float32),
    }
    if not dims.review_net_only:
        V, P, img = dims.view_size, config.photo_count, dims.photo_size
        spec["photos"] = ((B, V, P, img, img, 3), torch.uint8)
    return spec


def example_batch(spec, device):
    """A batch of the spec's shapes to trace with: every sentence and token
    present.  The traced graph does not depend on the values."""
    batch = {k: torch.zeros(shape, dtype=dtype, device=device)
             for k, (shape, dtype) in spec.items()}
    for p in ("u", "i", "ui"):
        S, L = spec[f"{p}_tokens"][0][1:]
        batch[f"{p}_lengths"].fill_(L)
        batch[f"{p}_counts"].fill_(S)
    batch["sample_mask"].fill_(1)
    return batch


class _Predict(nn.Module):
    """forward(params, batch) -> the kernel-free model's prediction (B,),
    with `params` a state dict of tensors.  The model is held outside the
    module tree, so its own weights are not part of the program."""

    def __init__(self, model):
        super().__init__()
        self._model = (model,)

    def forward(self, params, batch):
        return torch.func.functional_call(self._model[0], params, (batch,))[0]


def check_exportable(config):
    """Raise where the model itself raises: past the P ceiling that the
    long-history attention route shares with the JAX package's tiled
    kernel."""
    P = config.max_sent_count * config.max_sent_length
    D = 2 * config.gru_size
    if (config.batch_size * P * P * 4 > attention.TILED_BYTES_THRESHOLD
            and P > attention.max_tiled_p(D)):
        raise NotImplementedError(
            f"export: P = {P} exceeds the long-history attention route's ceiling "
            f"(~{attention.max_tiled_p(D)} at D = {D}); reduce "
            "max_sent_count/max_sent_length")


def export_predict(model, spec, device):
    """-> the ``torch.export`` program of the no-grad predict function
    (params, batch) -> pred of `model` (kernel-free, see ``ModelDims.
    use_kernels``), traced on `device` at `spec`'s shapes."""
    if model.dims.use_kernels:
        raise ValueError("export_predict takes the kernel-free model "
                         "(ModelDims.use_kernels False)")
    params = {n: p.detach().to(device) for n, p in model.state_dict().items()}
    with torch.no_grad():
        program = torch.export.export(_Predict(model.eval()),
                                      (params, example_batch(spec, device)), strict=False)
    program.example_inputs = None  # torch.export.save would write the weights with them
    return program


def custom_ops(program):
    """The sorted names of the port's custom ops in the program's graph
    (``namespace::name``)."""
    targets = (node.target for node in program.graph.nodes if node.op == "call_function")
    return sorted({t.name().split(".")[0] for t in targets
                   if getattr(t, "namespace", None) == CUSTOM_OP_NAMESPACE})


def _key_part(k):
    """A tree path element -> its sidecar key part: dict keys verbatim,
    list indices as '#i' (umpr_tpu/export.py's keys)."""
    return f"#{k}" if isinstance(k, int) else str(k)


def _flatten(node, prefix=()):
    if isinstance(node, dict):
        for k in sorted(node):
            yield from _flatten(node[k], prefix + (k,))
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from _flatten(v, prefix + (i,))
    else:
        yield "/".join(_key_part(k) for k in prefix), node


def _unflatten(flat):
    root = {}
    for key, v in flat.items():
        node = root
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.startswith("#") for k in node):
            return [fix(node[f"#{i}"]) for i in range(len(node))]
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


def save_artifact(path, program, params, meta=None):
    """Artifact = <path> (torch.export.save) + <path>.params.npz (the
    parameters in the JAX layout, path-keyed as the JAX package's sidecar)
    + <path>.json (metadata, with ``"custom_ops"``).  `params`: the
    model's state dict."""
    torch.export.save(program, path)
    tree = params_to_jax({n: t.detach().cpu() for n, t in params.items()})
    np.savez(path + ".params.npz", **{k: np.asarray(v, np.float32)
                                      for k, v in _flatten(tree)})
    with open(path + ".json", "w") as f:
        json.dump({**(meta or {}), "custom_ops": custom_ops(program)}, f, indent=2)


def load_params(path, device="cpu"):
    """The sidecar of either package -> the port's state dict on `device`."""
    with np.load(path + ".params.npz") as z:
        tree = _unflatten({k: z[k] for k in z.files})
    return {n: torch.as_tensor(np.ascontiguousarray(a)).to(device)
            for n, a in params_from_jax(tree).items()}


def program_device(program):
    """The device the program's traced tensors live on."""
    for node in program.graph.nodes:
        val = node.meta.get("val")
        if isinstance(val, torch.Tensor):
            return val.device
    return torch.device("cpu")


def load_predict(path, device=None):
    """-> (callable(params, batch) -> pred, params from the sidecar).

    `device` (default: the one the artifact was traced on) is where it
    runs: a program traced on another device is moved there with
    ``torch.export.passes.move_to_device_pass``.  params is the port's
    state dict on that device; batch a dict of tensors (or arrays) holding
    the artifact's spec (other keys are ignored), moved there at each
    call.  A long-history artifact's custom ops were registered when this
    module imported ``ops.attention_cuda``; they dispatch on their
    tensors' device."""
    program = torch.export.load(path)
    device = torch.device(device) if device is not None else program_device(program)
    if program_device(program) != device:
        from torch.export.passes import move_to_device_pass
        program = move_to_device_pass(program, device)
    module = program.module()
    # the program takes its two dicts' keys in the order it was traced with
    param_keys, batch_keys = (s.context for s in program.call_spec.in_spec.children()[0]
                              .children())

    def predict(params, batch):
        params = {k: params[k] for k in param_keys}
        batch = {k: torch.as_tensor(batch[k]).to(device) for k in batch_keys}
        with torch.no_grad():
            return module(params, batch)

    return predict, load_params(path, device)


def main(argv=None):
    from umpr_tpu_torch.config import Config
    from umpr_tpu_torch.text.vocab import Word2vec
    from umpr_tpu_torch.train import checkpoint as ckpt

    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--output", required=True)
    args, rest = parser.parse_known_args(argv)
    config = Config(rest)
    if not config.model_path:
        raise ValueError("--model_path is required for export")
    check_exportable(config)
    w2v = Word2vec(config.word2vec_file)
    dims = ModelDims.from_config(config, use_kernels=False)
    model = UMPR(dims, w2v.embedding)
    ckpt.restore_best(config.model_path, model)  # the embedding included
    spec = batch_spec(config, dims)
    program = export_predict(model, spec, config.torch_device)
    save_artifact(args.output, program, model.state_dict(), meta={
        "batch_size": config.batch_size, "review_net_only": dims.review_net_only,
        "device": str(config.torch_device), "compute_dtype": dims.compute_dtype,
        "input_keys": sorted(spec),
    })
    print(f"Exported predict program + params sidecar to {args.output}")
    return args.output


if __name__ == "__main__":
    main()
