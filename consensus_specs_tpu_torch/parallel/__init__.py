"""The multi-device path on torch.distributed (counterpart of parallel/):
the registry-sharded epoch step's layout (mesh.py), the two-axis
(dcn, data) layout (multihost.py) and the mesh collectives of the
randomized BLS check and the G1 sum (collectives.py)."""
