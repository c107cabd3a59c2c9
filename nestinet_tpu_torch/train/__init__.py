"""Training: schedules, the train and eval steps, the trainer."""
