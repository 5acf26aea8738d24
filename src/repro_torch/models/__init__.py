"""The port's model zoo: layers, model assembly, serving and training steps
and the converter between the JAX package's layout and the port's
(parameters, and the train state both ways): attention + dense layers
(musicgen-large), RWKV-6 (rwkv6-7b), Mamba + MoE (jamba-v0.1-52b)."""
