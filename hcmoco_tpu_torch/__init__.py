"""hcmoco_tpu_torch -- the PyTorch + CUDA port of hcmoco_tpu for NVIDIA Hopper.

Mirrors the layout of the JAX package (models/, contrast/, train/,
export/, ops/, data/, native/, utils/, cli/) with PyTorch idiom: nn.Modules
with the reference torch parameter names, NCHW activations (channels_last
on the card), explicit devices and torch.Generators.  Hand-written CUDA kernels live in csrc/ and
are built with nvcc at first use (_build.py), the host pipeline's C++ cores
(native/) with g++; importing the package needs no GPU, no CUDA toolkit, no
compiler and no JAX.
"""

__version__ = "0.1.0"
