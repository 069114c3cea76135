"""io: see the twin module under aerial_mapper_tpu/io/."""
