"""Transform families beyond C2C (port of ``vkfft_tpu/transforms``)."""
