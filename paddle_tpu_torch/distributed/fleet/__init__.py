"""``paddle_tpu/distributed/fleet`` counterpart: the pipeline layers."""
