"""Operation and byte counts of the model and its kernels, from shapes alone,
and the published peaks of the card they are held against."""
