"""PyTorch + CUDA port of the gSCAN multimodal seq2seq model.

Sits beside the JAX package ``multimodal_seq2seq_gscan_tpu`` (the reference it
is tested against) and imports nothing of it. Plain tensor code is PyTorch;
the decoder's hot loops (the greedy decode, and the teacher-forced unroll of
training with its backward) run in hand-written CUDA kernels (``ops/``,
sources in ``csrc/``) that are built with ``nvcc`` at first use. Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``; on CPU
tensors every kernel wrapper takes its plain PyTorch version instead. The
dataset engine and its analysis tools (``gscan/``, ``analysis/``,
``cli/gscan.py``) run on the host with numpy and the standard library.
"""
