"""The JAX package's validation and campaign scripts (``scripts/``), ported
to the GPU: each ``python -m faid_tpu_torch.scripts.<name>`` takes the
JAX script's flags plus ``--device`` (default ``cuda``) and writes its
artifacts under ``docs/torch_h100/``.

  fer_validation   the per-method FER waterfall, each row z-tested
                   against the JAX package's row
  channel_parity   both channel backends' FER against each other and the
                   JAX rows; the quantile channel's LLR law against a
                   float64 erfc oracle
  floor_campaign   a deep error-floor row, resumable across calls
  roofline         the decoder's three levels and the round's stages:
                   time, bound, share, the device's idle share
  backend_parity   the decoder kernels against their plain twin
  bench_decoder    the decoder kernel and its plain twin, timed in turns
"""
