"""utils: see the twin module under aerial_mapper_tpu/utils/."""
