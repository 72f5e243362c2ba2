"""The paper's FL examples on the port: ``python -m
repro_torch.examples.quickstart``, ``federated_mnist`` and
``clustered_cifar``. Each exposes ``main(argv=None)`` with the
reference's flags plus ``--device`` and runs nothing at import."""
