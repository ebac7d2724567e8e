"""Model zoo: lifters, backbones, heatmap heads, temporal, SMPL/IK.

Import models from their modules. The lifters (``lifters``, ``temporal``)
are plain JAX; the image models (``resnet``, ``heads``, ``smpl_pose``) use
``flax.linen``, so nothing here is imported eagerly.
"""
