"""The plain reference: the burn-in model's equations in plain PyTorch,
computed in f32 with TF32 off (:mod:`.model`). It imports nothing of the
port and takes only the inputs and weights the benchmark makes."""
