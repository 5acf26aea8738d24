"""Runtime of the port's training loop: fault tolerance (ft.py) and int8
gradient compression (compress.py).  The JAX package's sharding rules,
mesh context and elastic remesh are not ported yet (ROADMAP.md, A5)."""
