"""Native (C++) host components of the port: the SHA-256 pair hasher the
SSZ merkleization runs on (`hashtree`), built with the host compiler at
first use."""
