"""The cold-start FaaS runtime of the port: image build (``deploy``), the
staged boot pipeline (``boot``, ``drivers``) and the executor."""
