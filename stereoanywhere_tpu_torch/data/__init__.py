"""The benchmark readers (`datasets`), the file decoders (`frame_utils`, with
the EXR codec `exr`) and the host-side reprojection utilities (`warps`)."""
