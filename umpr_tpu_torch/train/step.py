"""Train and eval steps (port of umpr_tpu/train/step.py: the single-step
and multi-step paths).

Both run at the batch's runtime maxima: no ``pad_maxima`` in the batch, so
a statically padded batch trains and scores like the reference's
dynamically padded one (serving pins the full padding instead).  Dead rows
of a final partial batch (``sample_mask`` 0) reach neither the loss, its
gradient nor ``n_real``.  Neither step reads a value back to the host.
Dropout (full UMPR's VGG classifier) runs in the train step when it is
given a generator or pre-drawn masks, and never in the eval step.

``--steps_per_dispatch k`` (``make_multi_train_step`` and the multi-step
eval of the JAX package): ``MultiTrainStep`` and ``MultiEvalStep`` take a
chunk of k batches stacked on a new leading axis (``data.loader.
chunk_stream``) and run its steps in order.  On the CPU they are plain
loops of ``train_step`` / ``eval_step``, so ``--device cpu`` gives the
k = 1 bits.  On a card each is a ``DispatchGraph``: the k steps captured
once into one ``torch.cuda.CUDAGraph`` over static (k, B, ...) input
buffers, then one replay per chunk; a capture that fails raises, nothing
runs the chunk eagerly instead.

The device-resident corpus (``--device_dataset``, ``RESIDENT_FIELDS`` ...
``make_multi_eval_step_resident`` of the JAX package): ``gather_batch``
builds the loader's batch on the device from the packed arrays held
there, by a (B,) int32 row index and the count of live rows.  A single
step gathers and then runs ``train_step`` / ``eval_step``; the multi-step
classes take ``data=`` (the resident tensors) and a chunk of (k, B) row
indices and (k,) live counts, and gather inside the CUDA graph, which then
reads the resident tensors at their addresses: a graph captured over one
corpus is dropped (``drop_resident``) when the Trainer uploads another.

``--grad_accum_steps k`` (``make_train_step_accum``): ``train_step_accum``
runs the batch as k micro-batches, each at the full batch's runtime
maxima, with one ``backward()`` each into ``.grad`` and one Adam step.

Data parallelism (``parallel/``): with a ``mesh`` every step takes the
rank's row block of a global batch, which carries the global batch's
``pad_maxima`` and ``sample_count``, so the rank's loss terms and
gradients are partial sums of the global ones.  ``reduce_gradients`` adds
them up over the mesh's ``dp`` group in one ``all_reduce(SUM)`` after the
backward (once per optimizer step, micro-batches included) and before
Adam, which then steps identical replicas; the step's loss and count ride
in the same buffer, so the logged loss is the global one.  ``eval_step``
sums its (sq_sum, n) the same way.  Without a mesh nothing of this runs
and no collective is called.  On a card the all-reduce is captured in the
CUDA graph of ``--steps_per_dispatch k`` under NCCL; gloo's collectives
cannot be captured (the Trainer raises for k > 1 there).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.autograd.graph import increment_version

from umpr_tpu_torch.models.umpr import masked_sq_sum
from umpr_tpu_torch.models.visual_net import keep_masks
from umpr_tpu_torch.ops import attention_cuda, gru_cuda, masking, pool_cuda

RESIDENT_FIELDS = ("u_tokens", "u_lengths", "u_counts", "i_tokens", "i_lengths", "i_counts",
                   "ui_tokens", "ui_lengths", "ui_counts", "ratings")
# a rank's batch: facts of the global batch, not rows of it
GLOBAL_KEYS = ("pad_maxima", "sample_count")


def reduce_gradients(params, terms, group):
    """One ``all_reduce(SUM)`` over `group` of every gradient of `params`,
    in their order (a missing one as zeros, as Adam reads it), and the 0-d
    `terms` after them, in one flat f32 buffer; the gradients become views
    of the sum.  Returns the summed terms."""
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads] + [t.reshape(1).float() for t in terms])
    dist.all_reduce(flat, group=group)
    off = 0
    for p in params:
        p.grad = flat[off:off + p.numel()].view_as(p)
        off += p.numel()
    return tuple(flat[off + i] for i in range(len(terms)))


def train_step(model, opt, batch, lr=None, drop=None, mesh=None):
    """One Adam step -> (loss, n_real), 0-d device tensors: the batch's
    loss before the step (masked-mean MSE, plus loss_v_rate * loss_v for
    full UMPR) and its count of real samples.  lr: the learning rate from
    this step on (``opt.set_lr``; None keeps the optimizer's, as the
    Trainer sets it once an epoch).  drop: the dropout masks' source
    (UMPR.forward); None turns dropout off.  mesh: the rank's layout
    (parallel.mesh); the gradients, loss and count are then the global
    batch's."""
    if lr is not None:
        opt.set_lr(lr)
    opt.zero_grad(set_to_none=True)
    _, loss, _ = model(batch, drop)
    loss.backward()
    loss, n = loss.detach(), batch["sample_mask"].sum()
    if mesh is not None:
        loss, n = reduce_gradients(opt.params, (loss, n), mesh.dp_group)
    opt.step()
    return loss, n


def train_step_accum(model, opt, batch, k, drop=None, mesh=None):
    """One Adam step from k micro-batches of B / k samples (gradient
    accumulation) -> (loss, n_real, aux): the loss and aux terms are the
    sums of the micro-batches' terms, which add up to the single step's.
    Each micro-batch runs at the full batch's runtime maxima
    (``pad_maxima``) and its MSE term is its squared-error sum over the
    full batch's real-sample count, so the gradients sum to the single
    step's up to f32 rounding.  `drop`: a generator draws the
    micro-batches' dropout masks in their order; a list of masks over the
    batch's rows (a rank's, drawn as one rank's micro-batches draw them)
    is cut into the micro-batches' rows.  With a `mesh` the batch is a
    rank's row block (its global facts pin the maxima and the count) and
    one all-reduce before Adam sums the ranks' gradients and terms."""
    B = batch["sample_mask"].shape[0]
    if B % k:
        raise ValueError(f"batch {B} is not divisible by --grad_accum_steps {k}")
    mask = batch["sample_mask"]
    n_total = batch.get("sample_count", mask.sum()).clamp(min=1.0)
    pad_maxima = batch.get("pad_maxima")
    if pad_maxima is None:
        pad_maxima = (masking.batch_max_count(batch["u_counts"], batch["i_counts"]),
                      masking.batch_max_length(batch["u_lengths"], batch["i_lengths"]),
                      batch["ui_counts"].max(), batch["ui_lengths"].max())
    opt.zero_grad(set_to_none=True)
    m = B // k
    loss_sum, aux = 0.0, {}
    for j in range(k):
        micro = {key: v[j * m:(j + 1) * m] for key, v in batch.items()
                 if key not in GLOBAL_KEYS}
        micro["pad_maxima"] = pad_maxima
        micro_drop = drop
        if isinstance(drop, list):
            rows = drop[0].shape[0] // B * m  # dropout rows per micro-batch
            micro_drop = [d[j * rows:(j + 1) * rows] for d in drop]
        pred, _, micro_aux = model(micro, micro_drop)
        terms = {"loss_r": masked_sq_sum(pred, micro["ratings"], micro["sample_mask"])
                 / n_total}
        loss = terms["loss_r"]
        if "loss_v" in micro_aux:
            terms["loss_v"] = micro_aux["loss_v"]
            loss = loss + model.dims.loss_v_rate * micro_aux["loss_v"]
        loss.backward()
        loss_sum = loss_sum + loss.detach()
        for key, v in terms.items():
            aux[key] = aux.get(key, 0.0) + v.detach()
    n = mask.sum()
    if mesh is not None:
        loss_sum, n, *summed = reduce_gradients(opt.params, (loss_sum, n, *aux.values()),
                                                mesh.dp_group)
        aux = dict(zip(aux, summed))
    opt.step()
    return loss_sum, n, aux


@torch.no_grad()
def eval_step(model, batch, mesh=None):
    """-> (sum of squared errors over real samples, their count); with a
    `mesh`, the global batch's (summed over the ``dp`` group)."""
    pred, _, _ = model(batch)
    mask = batch["sample_mask"]
    sq, n = masked_sq_sum(pred, batch["ratings"], mask), mask.sum()
    if mesh is None:
        return sq, n
    parts = torch.stack([sq, n])
    dist.all_reduce(parts, group=mesh.dp_group)
    return parts[0], parts[1]


def mse_from_parts(parts):
    """(sq_sum, n) pairs, 0-d or (k,) per chunk -> dataset MSE = total
    squared error / sample count, summed on the host in batch order in
    float64 (the reference's evaluate_mse, src/evaluate.py:6-14); nan for
    an empty split.  One device->host copy for all parts."""
    parts = list(parts)
    if not parts:
        return float("nan")
    flat = torch.cat([torch.stack([sq.reshape(-1), n.reshape(-1)], 1)
                      for sq, n in parts]).cpu()
    total, count = 0.0, 0.0
    for sq, n in flat.tolist():
        total += sq
        count += n
    return total / count if count else float("nan")


def evaluate_mse(model, batches, mesh=None):
    """Dataset MSE over a stream of device batches, one eval_step each."""
    return mse_from_parts(eval_step(model, b, mesh) for b in batches)


def unstack(chunk, j):
    """Batch j of a chunk of stacked batches (views)."""
    return {key: v[j] for key, v in chunk.items()}


def gather_batch(data, idx, n_real, rows=None):
    """The loader's batch of dataset rows `idx` (B,) int32, gathered on the
    device from the resident tensors `data` (``RESIDENT_FIELDS``, and for
    full UMPR ``photo_bank`` (C, H, W, 3) uint8 with ``photo_idx`` (N, V,
    P) int32 bank rows).  Rows ``arange(B) >= n_real`` are dead and get
    the loader's padding of a final partial batch (data/loader.py): row
    0's values, sample_mask 0, counts 0, lengths 1 and bank row 0 (zeros,
    the photos of the path '').  Selects, never multiplies.  `rows`: a
    rank's row block of the global index; the batch then holds those rows
    and the global batch's facts (``GLOBAL_KEYS``), from its gathered
    counts and lengths."""
    if rows is not None:
        batch = gather_batch(data, idx[rows], n_real - rows.start)
        alive = torch.arange(idx.shape[0], device=idx.device) < n_real
        g = torch.where(alive, idx, 0).long()
        top = lambda key, pad: torch.where(alive.view(-1, *[1] * (data[key].dim() - 1)),
                                           data[key][g], pad).max()
        batch["pad_maxima"] = torch.stack([
            torch.maximum(top("u_counts", 0), top("i_counts", 0)),
            torch.maximum(top("u_lengths", 1), top("i_lengths", 1)),
            top("ui_counts", 0), top("ui_lengths", 1)])
        batch["sample_count"] = n_real.float()
        return batch
    B = idx.shape[0]
    alive = torch.arange(B, device=idx.device) < n_real
    rows = torch.where(alive, idx, 0).long()
    batch = {key: data[key][rows] for key in RESIDENT_FIELDS}
    batch["sample_mask"] = alive.float()
    for key in ("u_counts", "i_counts", "ui_counts"):
        batch[key] = torch.where(alive, batch[key], 0)
    for key in ("u_lengths", "i_lengths", "ui_lengths"):
        batch[key] = torch.where(alive[:, None], batch[key], 1)
    if "photo_bank" in data:
        photo_rows = torch.where(alive[:, None, None], data["photo_idx"][rows], 0)
        batch["photos"] = data["photo_bank"][photo_rows.long()]
    return batch


def batch_of(chunk, j, data=None, mesh=None):
    """Batch j of a chunk: a view of its stacked batches or, with the
    resident tensors `data`, gathered by its ``idx`` / ``n_real`` rows (a
    rank's row block of them on a `mesh`)."""
    if data is None:
        return unstack(chunk, j)
    rows = None if mesh is None else mesh.rows(chunk["idx"].shape[1])
    return gather_batch(data, chunk["idx"][j], chunk["n_real"][j], rows)


def chunk_len(chunk):
    """k, the number of batches of a chunk."""
    return next(iter(chunk.values())).shape[0]


def graphed(t):
    """Does a chunk on t's device run as a CUDA graph?  On the CPU it runs
    as a loop of single steps."""
    return t.device.type == "cuda"


def launch_counts():
    """{kernel name: its wrapper's launch count} over the port's kernels."""
    return {k.__name__: k.launches
            for m in (gru_cuda, pool_cuda, attention_cuda) for k in m.KERNELS}


class DispatchGraph:
    """One ``torch.cuda.CUDAGraph`` of a multi-step function over static
    input buffers (torch's whole-network capture recipe).

    ``fn(static) -> tuple of tensors`` runs once under capture; before it,
    ``warmup(static)`` (default fn) runs on a side stream, so that each
    kernel's library is loaded and its ``cudaFuncSetAttribute`` has run,
    and cuBLAS and cuDNN have their handles.  ``replay(inputs)`` copies
    each input into its static buffer and replays; the outputs it returns
    are overwritten by the next replay, so a caller copies what it keeps.
    Nothing the graph runs may read the device from the host: an
    ``.item()`` there fails the capture, which raises.

    Launch accounting: the kernel wrappers count a launch where they are
    called, so the capture counts once and a replay not at all.
    ``warmup_launches`` and ``captured`` are the counts that the warm-up
    and the capture added; the kernels ran ``warmup_launches + replays x
    captured`` times for this graph."""

    def __init__(self, fn, inputs, warmup=None):
        self.static = {k: v.clone() for k, v in inputs.items()}
        before = launch_counts()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            (warmup or fn)(self.static)
        torch.cuda.current_stream().wait_stream(side)
        warm = launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        # thread_local: the loader's prefetch thread keeps copying batches
        # to the device while this thread captures
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.outputs = fn(self.static)
        after = launch_counts()
        self.warmup_launches = {k: warm[k] - before[k] for k in before}
        self.captured = {k: after[k] - warm[k] for k in before}
        self.replays = 0

    def replay(self, inputs):
        for key, v in inputs.items():
            self.static[key].copy_(v)
        self.graph.replay()
        self.replays += 1
        return self.outputs


class MultiTrainStep:
    """k train steps per call (port of ``make_multi_train_step`` and
    ``make_multi_train_step_resident``): the chunk's batches in order, step
    j's dropout masks from its own generator, as k single steps would draw
    them.  Returns (loss * n_real, n_real), each (k,), fresh tensors.  A
    chunk holds only full steps; the Trainer runs remainders as single
    steps.  ``graph`` is the CUDA graph of the last call's source (stacked
    batches, or the resident tensors ``graph_data``).  With a `mesh` each
    step is a rank's (``train_step``'s all-reduce inside the graph)."""

    def __init__(self, model, opt, mesh=None):
        self.model, self.opt, self.mesh = model, opt, mesh
        self.graph = None
        self.graph_data = None

    def __call__(self, chunk, generators, data=None):
        """chunk: {field: (k, B, ...)} on the model's device or, with the
        resident tensors `data` (``gather_batch``), {"idx": (k, B),
        "n_real": (k,)} int32; generators: step j's dropout generator
        (Trainer.dropout_generator) or its masks pre-drawn (a list, a
        rank's rows of them), or Nones for UMPR-R."""
        k = chunk_len(chunk)
        if not graphed(next(iter(chunk.values()))):
            parts = [train_step(self.model, self.opt, batch_of(chunk, j, data, self.mesh),
                                drop=generators[j], mesh=self.mesh) for j in range(k)]
            return (torch.stack([loss * n for loss, n in parts]),
                    torch.stack([n for _, n in parts]))
        inputs = dict(chunk)
        shapes = self._dropout_shapes(chunk, data)
        if shapes:
            # Dropout cannot be seeded inside a graph: step j's masks are
            # drawn here, eagerly, by the generator and the calls of the
            # k = 1 step, into a buffer that the captured dropout reads
            device = next(iter(chunk.values())).device
            inputs["keep"] = torch.stack([torch.stack(
                g if isinstance(g, list) else keep_masks(shapes, g, device))
                for g in generators])
        if self.graph is None or self.graph_data is not data:
            # a graph reads its source's tensors at their addresses: one
            # captured over other resident tensors is dropped (the reference
            # held here keeps them alive until then)
            self.graph = None
            self.graph_data = data
            self.graph = DispatchGraph(self._capture, inputs, warmup=self._warmup)
        losses, ns = self.graph.replay(inputs)
        # the replay changed the parameters in place behind autograd's
        # version counters, which ops/gru.py's packed-operand cache reads
        for p in self.opt.params:
            increment_version(p)
        # the next replay overwrites the graph's outputs
        return losses.clone(), ns.clone()

    def drop_resident(self):
        """Drop a graph captured over resident tensors (their corpus is
        being replaced)."""
        if self.graph_data is not None:
            self.graph, self.graph_data = None, None

    def _dropout_shapes(self, chunk, data):
        if data is None:
            return self.model.dropout_shapes(unstack(chunk, 0))
        if self.model.dims.review_net_only:
            return []
        B, (V, P) = chunk["idx"].shape[1], data["photo_idx"].shape[1:]
        return self.model.visual_net.vgg16.dropout_shapes(B * V * P)

    def _batch(self, static, j):
        inputs = {key: v for key, v in static.items() if key != "keep"}
        return (batch_of(inputs, j, self.graph_data, self.mesh),
                static["keep"][j] if "keep" in static else None)

    def _warmup(self, static):
        """Forward and backward of the chunk's first batch, no optimizer
        step (the parameters stay as they are), then no grads: the capture
        allocates its own from the graph's pool."""
        batch, drop = self._batch(static, 0)
        _, loss, _ = self.model(batch, drop)
        loss.backward()
        self.opt.zero_grad(set_to_none=True)

    def _capture(self, static):
        losses, ns = [], []
        for j in range(chunk_len(static)):
            batch, drop = self._batch(static, j)
            loss, n = train_step(self.model, self.opt, batch, drop=drop, mesh=self.mesh)
            losses.append(loss * n)
            ns.append(n)
        return torch.stack(losses), torch.stack(ns)


class MultiEvalStep:
    """k eval steps per call (the JAX package's multi-step eval, and its
    resident twin with ``data=``): per batch (sq_sum, n), each (k,), fresh
    tensors.  On a card one graph per model and source it is called with:
    test() evaluates a fresh model restored from ``best/``, whose
    parameters a graph captured on the training model's does not read.
    With a `mesh` each batch is a rank's, and its parts the global sums."""

    def __init__(self, mesh=None):
        self.mesh = mesh
        # (id(model), id(data) or None) -> (model, data, DispatchGraph);
        # model and data are held so that their ids are not reused
        self.graphs = {}

    def __call__(self, model, chunk, data=None):
        k = chunk_len(chunk)
        step = lambda src, j: eval_step(model, batch_of(src, j, data, self.mesh), self.mesh)
        if not graphed(next(iter(chunk.values()))):
            parts = [step(chunk, j) for j in range(k)]
            return torch.stack([sq for sq, _ in parts]), torch.stack([n for _, n in parts])
        key = (id(model), None if data is None else id(data))
        entry = self.graphs.get(key)
        if entry is None:
            capture = lambda static: tuple(torch.stack(t) for t in zip(*(
                step(static, j) for j in range(k))))
            entry = self.graphs[key] = (model, data, DispatchGraph(capture, chunk))
        sq, n = entry[2].replay(chunk)
        # the next replay overwrites the graph's outputs, and the caller
        # keeps them until its last dispatch
        return sq.clone(), n.clone()

    def drop_resident(self):
        """Drop the graphs captured over resident tensors."""
        self.graphs = {key: e for key, e in self.graphs.items() if e[1] is None}

    def dispatch_graphs(self):
        return [e[2] for e in self.graphs.values()]
