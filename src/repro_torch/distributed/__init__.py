"""Distribution on ``torch.distributed``, one process per rank.

``group`` opens the rank's process group (``nccl`` on the card, ``gloo`` on
the CPU) and spawns CPU ranks; ``ctx`` registers the mesh's axes for model
code; ``shardspec`` and ``sharding`` resolve the parameter, cache and batch
specs against a mesh and place tensors on it as DTensors; ``pipeline`` is
GPipe over a mesh axis; ``cannon`` is the paper's two-level Cannon
(Algorithm 2): the inner Cannon over a grid of ranks, the outer hyperstep
level over the streams.
"""
