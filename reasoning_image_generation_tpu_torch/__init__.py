"""reasoning_image_generation_tpu_torch — PyTorch/CUDA port of the RPM pipeline."""
