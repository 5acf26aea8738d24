"""Runtime of the port: fault tolerance (ft.py), int8 gradient compression
(compress.py), the logical-axis sharding rules and mesh context on DTensor
(sharding.py) and elastic remesh (elastic.py)."""
