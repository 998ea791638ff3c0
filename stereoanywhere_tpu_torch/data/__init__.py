"""The benchmark readers (`datasets`) and the file decoders (`frame_utils`)."""
