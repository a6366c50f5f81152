"""The notebook's live profiler server: ``tensorflow.ProfilerService``
(the TF profiler's gRPC, which TensorBoard's profile-plugin capture button
calls) over ``torch.profiler``, with the card's kernels in the captured
``XSpace``.

``server`` is the service (``ProfilerServer``), ``xspace`` turns a
``torch.profiler`` session into an ``XSpace``, ``h2`` is the HTTP/2 and
gRPC transport and ``wire`` the protobuf format, both by hand on the
standard library. ``sdk.start_profiler_server`` is the entry point.
"""
