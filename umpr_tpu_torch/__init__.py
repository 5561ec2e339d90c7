"""umpr_tpu_torch -- the PyTorch/CUDA port of umpr_tpu for NVIDIA Hopper.

The JAX package ``umpr_tpu`` is the reference; this package computes the
same functions in PyTorch and replaces its Pallas TPU kernels with CUDA
C++ kernels written for ``sm_90a`` (``umpr_tpu_torch/csrc``).  It imports
neither JAX nor anything of ``umpr_tpu``: the host code it needs (flags,
vocabulary, dataset build, loader) is its own copy.

Ported so far: UMPR-R and full UMPR serving (``python -m
umpr_tpu_torch.serve``) and training (``python -m umpr_tpu_torch.main``),
export, the pretrainers (``python -m umpr_tpu_torch.train_embeddings``,
``-m umpr_tpu_torch.pretrain.abae``, ``-m umpr_tpu_torch.pretrain.rnet``)
and the VGG16 weight converter (``python -m umpr_tpu_torch.convert_vgg16``).
ROADMAP.md lists what comes next.

Entry points run on the card.  ``--device cpu`` is the only way onto the
CPU (the tests use it); there the kernel wrappers run their plain PyTorch
versions.
"""
