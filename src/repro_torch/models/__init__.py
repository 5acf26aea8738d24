"""The port's model zoo: layers, model assembly, serving steps and the
JAX-to-port weight converter: attention + dense layers (musicgen-large),
RWKV-6 (rwkv6-7b), Mamba + MoE (jamba-v0.1-52b)."""
