"""The embedding fleet of the port: replicas (``replica.py``), the
replica manager (``replica_manager.py``) and clients (``client.py``),
speaking the messages of ``proto/inference.proto`` (``wire.py``) over
gRPC-style frames on HTTP/1.1 (``transport.py``)."""
