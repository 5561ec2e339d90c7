"""umpr_tpu_torch -- the PyTorch/CUDA port of umpr_tpu for NVIDIA Hopper.

The JAX package ``umpr_tpu`` is the reference; this package computes the
same functions in PyTorch and replaces its Pallas TPU kernels with CUDA
C++ kernels written for ``sm_90a`` (``umpr_tpu_torch/csrc``).  It imports
neither JAX nor anything of ``umpr_tpu``: the host code it needs (flags,
vocabulary, dataset build, loader) is its own copy.

Ported so far: UMPR-R and full UMPR serving (``python -m
umpr_tpu_torch.serve``) and training (``python -m umpr_tpu_torch.main``),
export (``python -m umpr_tpu_torch.export``, the long-history route
included), the pretrainers (``python -m umpr_tpu_torch.train_embeddings``,
``-m umpr_tpu_torch.pretrain.abae``, ``-m umpr_tpu_torch.pretrain.rnet``),
the VGG16 weight converter (``python -m umpr_tpu_torch.convert_vgg16``) and
the offline data prep: the preprocessor (``python -m
umpr_tpu_torch.text.preprocess``, raw dumps to train/valid/test.csv and
photos.json) and the photo downloader (``python -m
umpr_tpu_torch.data.download``), host code that needs neither sklearn nor
nltk.  ROADMAP.md lists what comes next.

Entry points that compute on tensors run on the card.  ``--device cpu``
is the only way onto the CPU (the tests use it); there the kernel
wrappers run their plain PyTorch versions.  The data-prep CLIs and the
VGG16 converter are host code and take no device.
"""
