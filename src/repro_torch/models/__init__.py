"""The port's model zoo: layers, model assembly, serving steps and the
JAX-to-port weight converter (musicgen-large's attention + dense layers)."""
