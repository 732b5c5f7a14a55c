"""Training: AdamW, the LM / MoE / recsys / GNN train steps, the trainer
with checkpoint and resume, and the int8-compressed data-parallel step."""
