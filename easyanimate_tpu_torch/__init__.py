"""EasyAnimate in PyTorch for NVIDIA Hopper: the text-to-video serving path
of the V5.1 MMDiT and the MagViT decoder, with hand-written CUDA attention
kernels (csrc/), the loading of reference model directories (loader.py) and
the Qwen2-VL prompt encoder (models/text/). Module paths mirror the JAX
package `easyanimate_tpu`, which is the reference this package is tested
against."""
