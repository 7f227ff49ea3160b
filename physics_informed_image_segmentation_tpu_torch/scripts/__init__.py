"""The port's measurement scripts, each under the name of its counterpart in
the JAX repo's ``scripts/``; run one as
``python -m physics_informed_image_segmentation_tpu_torch.scripts.<name>``.
Each runs on the GPU unless given ``--device cpu``, and prints JSON lines,
every one with the card's name and power limit beside its times."""
