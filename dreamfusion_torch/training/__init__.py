"""Training: optimizer setup and the Trainer (train side); the DVGO
pretraining stack (dvgo_trainer, schedules, metrics, nerf_pipeline,
image_renderer)."""
