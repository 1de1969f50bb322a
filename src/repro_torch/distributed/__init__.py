"""Distribution: the paper's two-level Cannon (Algorithm 2) on one card.

Only the mesh-free part is ported: the outer hyperstep level over p
virtual cores of one device. The inner Cannon over a mesh of cards
(``cannon_matmul``) is not.
"""
