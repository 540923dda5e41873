"""The benchmark's plain reference: the math that the cells reach, in
plain PyTorch and in float32 (the grid field and its tiled encoder, the
occupancy-grid marcher, the compositor, the SD v1.5 UNet and VAE encoder,
the DVGO fine field on torch's grid_sample, the editing field), and the
training steps the cells compare (steps.py). No kernel dispatch; nothing
here imports the program."""
