# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: remote.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0cremote.proto\x12\tremote_pb\"\xfe\x03\n\nRemoteConf\x12\x0c\n\x04type\x18\x01 \x01(\t\x12\x0c\n\x04name\x18\x02 \x01(\t\x12\x15\n\rs3_access_key\x18\x04 \x01(\t\x12\x15\n\rs3_secret_key\x18\x05 \x01(\t\x12\x11\n\ts3_region\x18\x06 \x01(\t\x12\x13\n\x0bs3_endpoint\x18\x07 \x01(\t\x12\x18\n\x10s3_storage_class\x18\x08 \x01(\t\x12\x1b\n\x13s3_force_path_style\x18\t \x01(\x08\x12\x17\n\x0fs3_v4_signature\x18\x0b \x01(\x08\x12*\n\"gcs_google_application_credentials\x18\n \x01(\t\x12\x16\n\x0egcs_project_id\x18\x0c \x01(\t\x12\x1a\n\x12\x61zure_account_name\x18\x0f \x01(\t\x12\x19\n\x11\x61zure_account_key\x18\x10 \x01(\t\x12\x18\n\x10\x62\x61\x63kblaze_key_id\x18\x14 \x01(\t\x12!\n\x19\x62\x61\x63kblaze_application_key\x18\x15 \x01(\t\x12\x1a\n\x12\x62\x61\x63kblaze_endpoint\x18\x16 \x01(\t\x12\x18\n\x10\x62\x61\x63kblaze_region\x18\x17 \x01(\t\x12\x12\n\nlocal_root\x18\x64 \x01(\t\x12\x14\n\x0cgcs_endpoint\x18\x65 \x01(\t\x12\x16\n\x0e\x61zure_endpoint\x18\x66 \x01(\t\"\xcf\x01\n\x14RemoteStorageMapping\x12?\n\x08mappings\x18\x01 \x03(\x0b\x32-.remote_pb.RemoteStorageMapping.MappingsEntry\x12#\n\x1bprimary_bucket_storage_name\x18\x02 \x01(\t\x1aQ\n\rMappingsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12/\n\x05value\x18\x02 \x01(\x0b\x32 .remote_pb.RemoteStorageLocation:\x02\x38\x01\"C\n\x15RemoteStorageLocation\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0e\n\x06\x62ucket\x18\x02 \x01(\t\x12\x0c\n\x04path\x18\x03 \x01(\tb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'remote_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _REMOTESTORAGEMAPPING_MAPPINGSENTRY._options = None
  _REMOTESTORAGEMAPPING_MAPPINGSENTRY._serialized_options = b'8\001'
  _REMOTECONF._serialized_start=28
  _REMOTECONF._serialized_end=538
  _REMOTESTORAGEMAPPING._serialized_start=541
  _REMOTESTORAGEMAPPING._serialized_end=748
  _REMOTESTORAGEMAPPING_MAPPINGSENTRY._serialized_start=667
  _REMOTESTORAGEMAPPING_MAPPINGSENTRY._serialized_end=748
  _REMOTESTORAGELOCATION._serialized_start=750
  _REMOTESTORAGELOCATION._serialized_end=817
# @@protoc_insertion_point(module_scope)
