"""PyTorch/CUDA port of the VQA transfer-learning framework.

The package mirrors the module layout of ``vqa_transfer_externaldata_tpu``
so each module's counterpart is easy to find, but it imports nothing of it
(and never JAX): plain tensor code is PyTorch, and each Pallas kernel of the
reference becomes a hand-written CUDA kernel for Hopper (``csrc/``) with a
plain PyTorch version of the same math beside it. Entry points run on CUDA
unless the caller passes ``device="cpu"``.

Every module of the reference has its counterpart: serving, both training
stages and the transfer, evaluation, checkpoints, every stage-2 family,
the int8 store, the H100 probes, the real-data preprocessing
(``cli.preprocess``), the native host-IO libraries (``native/``,
``data/native.py``) and the grain pipeline (``data/grain_loader.py``);
``ROADMAP.md`` lists what is left.
"""

__version__ = "0.1.0"
