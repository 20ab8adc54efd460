"""The port's example scripts (counterparts of the repository's
``scripts/``): each runs as ``python -m framefusion_tpu_torch.scripts.<name>``
on the card, or with ``--device cpu`` on the CPU, and keeps its work in a
function that takes a built model, so tests and the smoke run drive it in
process."""
