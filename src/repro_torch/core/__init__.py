"""Books, symbol planes, the chunked wire format and the plain-torch
codecs (port of ``repro.core``)."""
