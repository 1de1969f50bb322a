"""Distribution: the paper's two-level Cannon (Algorithm 2) on one card, and
the sharding rule tables.

Of Cannon only the mesh-free part is ported: the outer hyperstep level over
p virtual cores of one device. The inner Cannon over a mesh of cards
(``cannon_matmul``) is not. ``shardspec`` and ``sharding`` resolve the
parameter, cache and batch specs against a mesh's shape; placing tensors on
a mesh is not ported yet.
"""
