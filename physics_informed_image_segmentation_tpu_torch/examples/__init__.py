"""The port's examples, each under the name of its counterpart in the JAX
repo's ``examples/``; run one as
``python -m physics_informed_image_segmentation_tpu_torch.examples.<name>``."""
