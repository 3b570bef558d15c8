"""The host's time to issue a batch of the encode window, ms: the mean
`cocodr.encode.dispatch` span (pipelines/encode.py::Encoder.dispatch: the
tower's launches and the copy of its embeddings enqueued). Beside
batch_card_ms.encode it is the host's headroom over the card."""
from portbench import spans


def read(run):
    return spans.mean_ms(run, "cocodr.encode.dispatch")
